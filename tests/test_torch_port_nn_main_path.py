"""The models on ``nn.Layer`` keep the main path as it was.

- Zero op-registry dispatches during a test-tiny GPT ``TrainStep``
  (AdamW with fp32 masters, the fused LM-head loss), a dense
  ``ServingEngine`` serving two requests, and a fused-ResNet
  ``TrainStep`` (Momentum): their weights are the port's
  ``Parameter``s, whose methods and operators dispatch, so every main
  path reads them through torch functions or plain views. Counted by
  wrapping ``op_registry._dispatch_body``, which every dispatch runs.
- Each model is an ``nn.Layer`` whose sublayers are ``Layer``s and
  whose weights are ``Parameter``s. (Their ``state_dict`` keys and
  ``named_parameters`` order are pinned to the JAX models' beside each
  model's parity tests, on the JAX model those tests build:
  ``test_keys_and_parameter_order_equal_the_jax_model`` in
  ``tests/test_torch_port_gpt.py``, ``_ernie.py`` and ``_resnet.py``.)
- The coverage gate: every name of ``tests/data_ref_nn_all.txt`` that
  ``paddle_tpu.nn`` defines resolves in ``paddle_tpu_torch.nn``, or is
  listed once in ``LATER`` with its ROADMAP queue item.
"""
import importlib
import os

import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu_torch as tp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.inference import Config
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.ops import op_registry
from paddle_tpu_torch.serving import RequestParams, ServingEngine

tgpt = importlib.import_module("paddle_tpu_torch.models.gpt")
ternie = importlib.import_module("paddle_tpu_torch.models.ernie")
tresnet = importlib.import_module("paddle_tpu_torch.models.resnet")

_HERE = os.path.dirname(os.path.abspath(__file__))

# names of paddle_tpu.nn that later queue items port
_A2B2 = (
    "AdaptiveAvgPool1D AdaptiveAvgPool3D AdaptiveMaxPool1D AdaptiveMaxPool2D "
    "AdaptiveMaxPool3D AlphaDropout AvgPool1D AvgPool2D AvgPool3D BatchNorm "
    "BatchNorm1D BatchNorm3D BeamSearchDecoder BiRNN Bilinear ChannelShuffle "
    "Conv1D Conv1DTranspose Conv2DTranspose Conv3D Conv3DTranspose "
    "CosineSimilarity Dropout3D Fold GRU GRUCell GroupNorm Identity "
    "InstanceNorm1D InstanceNorm2D InstanceNorm3D LSTM LSTMCell "
    "LocalResponseNorm MaxPool1D MaxPool3D MaxUnPool1D MaxUnPool2D "
    "MaxUnPool3D Pad1D Pad2D Pad3D PairwiseDistance PixelShuffle "
    "PixelUnshuffle RNN RNNCellBase RReLU SimpleRNN SimpleRNNCell "
    "SpectralNorm Unfold Upsample UpsamplingBilinear2D UpsamplingNearest2D "
    "ZeroPad2D dynamic_decode").split()
LATER = dict({n: "A2b-2" for n in _A2B2}, SyncBatchNorm="A11")


@pytest.fixture
def dispatches(monkeypatch):
    """Counts every op-registry dispatch by name."""
    seen = {}
    body = op_registry._dispatch_body

    def counting(name, *args, **kwargs):
        seen[name] = seen.get(name, 0) + 1
        return body(name, *args, **kwargs)

    monkeypatch.setattr(op_registry, "_dispatch_body", counting)
    return seen


def _gpt(**overrides):
    return tgpt.gpt("test-tiny", device="cpu",
                    generator=torch.Generator().manual_seed(0), **overrides)


def test_gpt_trainstep_dispatches_nothing(dispatches):
    """bench.py's recipe at test-tiny: bf16 weights, so AdamW keeps fp32
    masters."""
    model = _gpt(fused_lm_loss=True, dtype=torch.bfloat16)
    assert all(isinstance(p, tp.Parameter) for p in model.parameters())
    opt = toptim.AdamW(1e-3, parameters=model.parameters(),
                       multi_precision=True)
    step = TrainStep(model, opt, lambda out, y: model.loss(out, y))
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, 512, (2, 16)))
    losses = [float(step(ids, ids)) for _ in range(3)]
    assert losses[-1] < losses[0]
    assert dispatches == {}
    masters = [opt.state_for(p)["master"] for p in model.parameters()]
    assert all(type(m) is torch.Tensor for m in masters)


def test_dense_engine_step_dispatches_nothing(dispatches):
    model = _gpt().eval()
    cfg = (Config().from_layer(model).disable_gpu()
           .enable_generation(max_new_tokens=4, prefill_buckets=(16,),
                              max_batch=2))
    eng = ServingEngine(cfg)
    handles = [eng.submit(np.arange(1, 6 + i), RequestParams(
        max_new_tokens=4)) for i in range(2)]
    outs = [h.result(timeout=60) for h in handles]
    assert all(len(o) == 4 for o in outs)
    assert dispatches == {}


def test_fused_resnet_trainstep_dispatches_nothing(dispatches):
    model = tresnet.ResNet(tresnet.BottleneckBlock, [1, 1, 1, 1],
                           num_classes=4, data_format="NHWC", fused_bn=True,
                           stem_space_to_depth=True, device="cpu",
                           generator=torch.Generator().manual_seed(1))
    opt = toptim.Momentum(0.01, 0.9, parameters=model.parameters())
    step = TrainStep(model, opt, lambda lg, y: tnn.functional.cross_entropy(
        lg.float(), y))
    rng = np.random.RandomState(2)
    x = torch.as_tensor(rng.randn(2, 3, 32, 32).astype(np.float32))
    y = torch.as_tensor(rng.randint(0, 4, (2,)))
    losses = [float(step(x, y)) for _ in range(2)]
    assert all(np.isfinite(losses))
    assert dispatches == {}


@pytest.mark.parametrize("which", ["gpt", "ernie", "resnet"])
def test_models_are_layers_with_parameters(which):
    if which == "gpt":
        tm = _gpt()
    elif which == "ernie":
        tm = ternie.ernie("test-tiny", device="cpu")
    else:
        tm = tresnet.ResNet(tresnet.BottleneckBlock, [2, 1, 1, 2],
                            num_classes=10, data_format="NHWC",
                            fused_bn=True, device="cpu")
    assert isinstance(tm, tnn.Layer) and isinstance(tm, torch.nn.Module)
    assert all(isinstance(m, tnn.Layer) for m in tm.sublayers())
    assert all(isinstance(p, tp.Parameter) for p in tm.parameters())
    assert type(next(tm.parameters())) is tp.Parameter
    assert len(tm.state_dict()) == len(tm.parameters()) + len(tm.buffers())


def test_nn_coverage_gate():
    names = open(os.path.join(_HERE, "data_ref_nn_all.txt")).read().split()
    defined = [n for n in names if hasattr(jnn, n)]
    missing = sorted(n for n in defined if not hasattr(tnn, n))
    assert missing == sorted(LATER)
    assert not [n for n in LATER if hasattr(tnn, n)]
    assert isinstance(tp.nn.Layer, type) and tp.ParamAttr is tnn.ParamAttr
    assert issubclass(tnn.Layer, torch.nn.Module)
