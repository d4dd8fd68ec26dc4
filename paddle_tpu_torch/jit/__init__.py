"""Training step and functional autodiff (the JAX package's ``jit/``)."""
from .api import (TrainStep, functional_call, grad,  # noqa: F401
                  value_and_grad)
