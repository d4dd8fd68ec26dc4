"""paddle.autograd (the JAX package's ``autograd/``) on torch's
autograd: ``backward``, ``grad``, ``PyLayer`` and the grad modes."""
from ..core.tensor import enable_grad, is_grad_enabled, no_grad  # noqa: F401
from .backward_engine import run_backward, tensor_grad  # noqa: F401
from .backward_engine import tensor_grad as grad  # noqa: F401
from .py_layer import PyLayer, PyLayerContext  # noqa: F401


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward: ``backward`` of each of ``tensors`` with
    its entry of ``grad_tensors`` as the seed."""
    if not isinstance(tensors, (list, tuple)):
        tensors = [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    for t, g in zip(tensors, grad_tensors):
        run_backward(t, g, retain_graph)
