from .ernie import (ErnieConfig, ErnieForPretraining,  # noqa: F401
                    ErnieForSequenceClassification, ErnieModel, bert,
                    ernie)
from .gpt import (CONFIGS, GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  gpt)
from .resnet import (ResNet, resnet18, resnet34, resnet50,  # noqa: F401
                     resnet101, resnet152)
