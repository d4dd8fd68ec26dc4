"""Quantization (the JAX package's ``quantization/``): post-training
quantization, the int8 compute path and quantization-aware training
(``QAT``, ``QuantedLinear``, ``QuantedConv2D``)."""
from .config import QuantConfig  # noqa: F401
from .fake_quant import (dequantize_int8, fake_quant,  # noqa: F401
                         fake_quant_channelwise, quantize_int8)
from .int8_compute import (Int8ComputeConv2D,  # noqa: F401
                           Int8ComputeLinear, convert_to_int8_compute)
from .observers import (AbsmaxObserver, AVGObserver,  # noqa: F401
                        ChannelWiseAbsmaxObserver)
from .ptq import PTQ  # noqa: F401
from .qat import QAT, QuantedConv2D, QuantedLinear  # noqa: F401
