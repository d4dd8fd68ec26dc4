"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (``kernels.flash_attention``, ``kernels.fused_resnet``,
``kernels.fused_norm``, ``kernels.fused_adamw``,
``kernels.fused_ce``). Sources live in
``../csrc`` and are built by ``kernels._build`` on first use."""
from .fused_adamw import fused_adamw_update  # noqa: F401
from .fused_ce import fused_linear_ce  # noqa: F401
from .fused_norm import fused_layer_norm, fused_rms_norm  # noqa: F401
