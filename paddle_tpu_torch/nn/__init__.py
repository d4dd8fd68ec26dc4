from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .container import LayerList, Sequential  # noqa: F401
from .layers_common import (AdaptiveAvgPool2D, BatchNorm2D,  # noqa: F401
                            BCELoss, BCEWithLogitsLoss, Conv2D,
                            CrossEntropyLoss, Dropout, Embedding, KLDivLoss,
                            L1Loss, LayerNorm, Linear, MaxPool2D, MSELoss,
                            NLLLoss, ReLU, RMSNorm, SmoothL1Loss)
from .layers_wrap import (CTCLoss, CosineEmbeddingLoss,  # noqa: F401
                          HingeEmbeddingLoss, HSigmoidLoss,
                          MarginRankingLoss, MultiLabelSoftMarginLoss,
                          MultiMarginLoss, SoftMarginLoss,
                          TripletMarginLoss, TripletMarginWithDistanceLoss)
