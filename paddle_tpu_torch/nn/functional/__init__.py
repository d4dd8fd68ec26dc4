"""Functionals the ported modules use (``torch.nn.functional`` covers
the rest)."""
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import flatten, linear, pad, relu  # noqa: F401
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
