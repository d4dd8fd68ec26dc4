"""``Sequential`` and ``LayerList`` (the JAX package's
``nn/container.py``): children are named ``0``, ``1``, ..., so a block's
keys read ``layer1.0.downsample.0.weight`` in both packages."""
from torch.nn import ModuleList, Sequential  # noqa: F401


#: the JAX package's ``LayerList``: keys read ``ernie.layers.0.attn...``
#: in both packages
LayerList = ModuleList
