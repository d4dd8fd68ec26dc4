from . import functional  # noqa: F401
from .container import Sequential  # noqa: F401
from .layers_common import (AdaptiveAvgPool2D, BatchNorm2D,  # noqa: F401
                            Conv2D, CrossEntropyLoss, Dropout, Embedding,
                            LayerNorm, Linear, MaxPool2D, ReLU,
                            RMSNorm)
