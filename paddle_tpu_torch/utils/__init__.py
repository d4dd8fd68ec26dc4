"""Utilities of the port (the JAX package's ``utils/``)."""
