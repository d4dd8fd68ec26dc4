"""``paddle.nn`` on torch: ``Layer`` (a ``torch.nn.Module``), the
containers, initializers, layers, activations, losses and the
Transformer; ``functional`` holds the functions."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .container import (LayerDict, LayerList,  # noqa: F401
                        ParameterList, Sequential)
from .initializer import ParamAttr  # noqa: F401
from .layer import Layer  # noqa: F401
from .layers_common import (ELU, GELU, AdaptiveAvgPool2D,  # noqa: F401
                            BatchNorm2D, BCELoss, BCEWithLogitsLoss, Conv2D,
                            CrossEntropyLoss, Dropout, Dropout2D, Embedding,
                            Flatten, Hardsigmoid, Hardswish, KLDivLoss,
                            L1Loss, LayerNorm, LeakyReLU, Linear,
                            LogSoftmax, MaxPool2D, Mish, MSELoss, NLLLoss,
                            PReLU, ReLU, ReLU6, RMSNorm, Sigmoid, Silu,
                            SmoothL1Loss, Softmax, Swish, Tanh)
from .layers_wrap import (CELU, SELU, CosineEmbeddingLoss,  # noqa: F401
                          CTCLoss, Hardshrink, Hardtanh,
                          HingeEmbeddingLoss, HSigmoidLoss, LogSigmoid,
                          MarginRankingLoss, Maxout,
                          MultiLabelSoftMarginLoss, MultiMarginLoss,
                          Softmax2D, SoftMarginLoss, Softplus, Softshrink,
                          Softsign, Tanhshrink, ThresholdedReLU,
                          TripletMarginLoss, TripletMarginWithDistanceLoss)
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
from ..optimizer.grad_clip import (ClipGradByGlobalNorm,  # noqa: F401
                                   ClipGradByNorm, ClipGradByValue)
