"""The ``nn`` functionals on plain torch tensors (a ``Tensor`` in gives a
``Tensor`` out through torch's own dispatch). The activations,
``linear``, ``embedding`` and ``scaled_dot_product_attention`` are also
registered in the op registry under the JAX package's names; the
registry's wrappers dispatch, the functions here do not."""
from .activation import (celu, elu, gelu, glu, gumbel_softmax,  # noqa: F401
                         hardshrink, hardsigmoid, hardswish, hardtanh,
                         leaky_relu, log_sigmoid, log_softmax, maxout,
                         mish, prelu, relu, relu6, selu, sigmoid, silu,
                         softmax, softplus, softshrink, softsign, swish,
                         tanh, tanh_act, tanhshrink, thresholded_relu)
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import (dropout, dropout2d, embedding, flatten,  # noqa: F401
                     linear, pad)
from .conv import conv2d  # noqa: F401
from .loss import (binary_cross_entropy,  # noqa: F401
                   binary_cross_entropy_with_logits, cosine_embedding_loss,
                   cross_entropy, ctc_loss, edit_distance,
                   hinge_embedding_loss, hsigmoid_loss, kl_div, l1_loss,
                   margin_ranking_loss, mse_loss,
                   multi_label_soft_margin_loss, multi_margin_loss,
                   nll_loss, sigmoid_focal_loss, smooth_l1_loss,
                   soft_margin_loss, softmax_with_cross_entropy,
                   square_error_cost, triplet_margin_loss,
                   triplet_margin_with_distance_loss)
from .norm import (batch_norm_infer, batch_norm_train,  # noqa: F401
                   layer_norm, rms_norm)
from .pooling import adaptive_avg_pool2d, max_pool2d  # noqa: F401

from ...ops.op_registry import op as _op  # noqa: E402

#: the JAX package's OPS names of the functions registered here
REGISTERED = (
    "relu", "relu6", "sigmoid", "log_sigmoid", "silu", "softsign",
    "tanh_act", "mish", "gelu", "elu", "selu", "celu", "leaky_relu",
    "prelu", "hardtanh", "hardshrink", "softshrink", "hardsigmoid",
    "hardswish", "softplus", "tanhshrink", "thresholded_relu", "softmax",
    "log_softmax", "gumbel_softmax", "glu", "maxout",
    "scaled_dot_product_attention", "linear", "embedding",
)
for _name in REGISTERED:
    _op(_name)(globals()[_name])
