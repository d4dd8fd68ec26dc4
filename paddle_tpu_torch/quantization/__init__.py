"""Post-training quantization and the int8 compute path (the JAX
package's ``quantization/``). Quantization-aware training (``QAT``,
``QuantedLinear``, ``QuantedConv2D``) is not ported yet: it waits for
the training surface of ROADMAP A4 and A13."""
from .config import QuantConfig  # noqa: F401
from .fake_quant import (dequantize_int8, fake_quant,  # noqa: F401
                         fake_quant_channelwise, quantize_int8)
from .int8_compute import (Int8ComputeConv2D,  # noqa: F401
                           Int8ComputeLinear, convert_to_int8_compute)
from .observers import (AbsmaxObserver, AVGObserver,  # noqa: F401
                        ChannelWiseAbsmaxObserver)
from .ptq import PTQ  # noqa: F401
