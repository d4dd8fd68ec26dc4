"""``fleet`` of the port: so far ``fleet.utils.recompute`` (the rest of
fleet is ROADMAP A11)."""
from . import utils  # noqa: F401
