"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (``kernels.flash_attention``, ``kernels.fused_resnet``). Sources
live in ``../csrc`` and are built by ``kernels._build`` on first use."""
