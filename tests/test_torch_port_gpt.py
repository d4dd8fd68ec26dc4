"""The port's GPT against the JAX package's, on test-tiny in fp32 with
the JAX weights carried across by ``convert.load_reference_state``;
plus the weight converter itself and the port's package hygiene.

Tolerance for logits: 1e-4 absolute and relative — both packages run
the same fp32 arithmetic, differing only in the order of matmul sums
(XLA against PyTorch's CPU BLAS) over two layers.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import gpt as jax_gpt
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM, gpt

TOL = dict(atol=1e-4, rtol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(jax_model):
    return {k: np.asarray(v._data) for k, v in jax_model.state_dict().items()}


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = jax_gpt("test-tiny")
    jm.eval()
    tm = gpt("test-tiny", device="cpu")
    load_reference_state(tm, _arrays(jm))
    tm.eval()
    return jm, tm


def _jax(x):
    return paddle.to_tensor(np.asarray(x, np.int32))


# ---------------------------------------------------------- converter


def test_converter_round_trips_every_key_and_shape(pair):
    jm, tm = pair
    arrays = _arrays(jm)
    own = tm.state_dict()
    assert list(own) == list(arrays)
    for name, t in own.items():
        assert tuple(t.shape) == arrays[name].shape, name
        np.testing.assert_array_equal(t.numpy(), arrays[name], err_msg=name)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype"])
def test_converter_is_strict(pair, fault):
    jm, _ = pair
    arrays = _arrays(jm)
    if fault == "missing":
        arrays.pop("gpt.ln_f.bias")
        err = KeyError
    elif fault == "extra":
        arrays["gpt.lm_head.weight"] = np.zeros((64, 512), np.float32)
        err = KeyError
    elif fault == "shape":
        arrays["gpt.embed.wpe.weight"] = np.zeros((64, 64), np.float32)
        err = ValueError
    else:
        arrays["gpt.ln_f.weight"] = arrays["gpt.ln_f.weight"].astype(
            np.float16)
        err = TypeError
    target = gpt("test-tiny", device="cpu")
    before = {k: v.clone() for k, v in target.state_dict().items()}
    with pytest.raises(err):
        load_reference_state(target, arrays)
    for k, v in target.state_dict().items():   # nothing was written
        assert torch.equal(v, before[k]), k


# ------------------------------------------------------- model parity


@pytest.mark.parametrize("tied", [True, False])
def test_full_forward_logits_match(pair, tied):
    jm, tm = pair
    if not tied:                      # separate lm_head.weight [in, out]
        paddle.seed(1)
        jm = jax_gpt("test-tiny", tie_word_embeddings=False)
        jm.eval()
        tm = gpt("test-tiny", device="cpu", tie_word_embeddings=False)
        load_reference_state(tm, _arrays(jm))
        assert tuple(tm.state_dict()["lm_head.weight"].shape) == (64, 512)
    ids = np.random.RandomState(0).randint(0, 512, (2, 24))
    ref = np.asarray(jm(_jax(ids))._data)
    with torch.no_grad():
        out = tm(torch.as_tensor(ids)).numpy()
    assert out.shape == (2, 24, 512)
    np.testing.assert_allclose(out, ref, **TOL)


def test_prefill_ragged_and_teacher_forced_decode_match(pair):
    """Right-padded prompts with ragged prompt_len: the prefill's
    next-token logits, then N teacher-forced decode steps."""
    jm, tm = pair
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 512, (3, 20))
    plen = np.array([20, 9, 1], np.int32)
    forced = rng.randint(0, 512, (5, 3))
    j_logits, j_cache = jm(_jax(ids), use_cache=True,
                           prompt_len=_jax(plen), cache_max_len=48)
    with torch.no_grad():
        t_logits, t_cache = tm(torch.as_tensor(ids), use_cache=True,
                               prompt_len=torch.as_tensor(plen),
                               cache_max_len=48)
        np.testing.assert_allclose(t_logits.numpy(),
                                   np.asarray(j_logits._data), **TOL)
        np.testing.assert_array_equal(t_cache.kv_len.numpy(), plen)
        for tok in forced:
            j_logits, j_cache = jm(_jax(tok[:, None]), cache=j_cache)
            t_logits, t_cache = tm(torch.as_tensor(tok)[:, None],
                                   cache=t_cache)
            np.testing.assert_allclose(t_logits.numpy(),
                                       np.asarray(j_logits._data), **TOL)
    np.testing.assert_array_equal(t_cache.kv_len.numpy(),
                                  np.asarray(j_cache.kv_len))


def test_bf16_layer_norm_matches_jax():
    """LayerNorm on bf16 input: fp32 statistics, cast back, then scale
    and shift in bf16, as the JAX package does (bitwise on the CPU)."""
    import jax.numpy as jnp
    from paddle_tpu.nn.functional.norm import layer_norm as jax_ln
    from paddle_tpu_torch.nn.functional import layer_norm
    rng = np.random.RandomState(2)
    x, w, b = rng.randn(4, 64), rng.randn(64), rng.randn(64)
    ref = jax_ln(jnp.asarray(x, jnp.bfloat16), (64,),
                 jnp.asarray(w, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    ref = np.asarray(getattr(ref, "_data", ref).astype(jnp.float32))
    out = layer_norm(torch.tensor(x).bfloat16(), (64,),
                     torch.tensor(w).bfloat16(),
                     torch.tensor(b).bfloat16()).float().numpy()
    np.testing.assert_array_equal(out, ref)


def test_training_options_raise():
    """Options the port has not taken yet raise (ROADMAP A11); the fused
    LM loss and recompute are ported and build."""
    for opt in (dict(sequence_parallel=True), dict(moe_num_experts=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP A11"):
            gpt("test-tiny", device="cpu", **opt)
    assert gpt("test-tiny", device="cpu", fused_lm_loss=True).cfg.fused_lm_loss
    assert gpt("test-tiny", device="cpu", use_recompute=True).cfg.use_recompute


def test_initializer_is_seeded_by_generator():
    a = gpt("test-tiny", device="cpu",
            generator=torch.Generator().manual_seed(3))
    b = gpt("test-tiny", device="cpu",
            generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    w = a.gpt.blocks[0].attn.qkv_proj.weight
    assert w.shape == (64, 192)
    assert abs(float(w.detach().std()) - 0.02) < 0.003


# ---------------------------------------------------- package hygiene


def test_import_leaves_jax_and_the_jax_package_out():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.models, paddle_tpu_torch.convert, "
            "paddle_tpu_torch.kernels.flash_attention, "
            "paddle_tpu_torch.optimizer, paddle_tpu_torch.jit, "
            "paddle_tpu_torch.core.metrics, paddle_tpu_torch.core.monitor, "
            "paddle_tpu_torch.core.flight_recorder, "
            "paddle_tpu_torch.core.timeseries, paddle_tpu_torch.core.goodput, "
            "paddle_tpu_torch.core.slo, paddle_tpu_torch.core.flags, "
            "paddle_tpu_torch.core.enforce, paddle_tpu_torch.core.prof_hook, "
            "paddle_tpu_torch.profiler, paddle_tpu_torch.profiler.metrics, "
            "paddle_tpu_torch.profiler.profiler, "
            "paddle_tpu_torch.profiler.statistic, "
            "paddle_tpu_torch.utils.fault_injection, "
            "paddle_tpu_torch.serving.router, "
            "paddle_tpu_torch.core.telemetry_server, "
            "paddle_tpu_torch.distributed, "
            "paddle_tpu_torch.distributed.resilience\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu' "
            "or m == 'triton']\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    """Without device='cpu', an entry point wants a card: where none is
    visible it raises instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTForCausalLM(GPTConfig(vocab_size=32, hidden_size=16,
                                 num_layers=1, num_heads=2))
    from paddle_tpu_torch.inference import Config
    from paddle_tpu_torch.serving import ServingEngine
    tiny = gpt("test-tiny", device="cpu")
    cfg = Config().from_layer(tiny).enable_generation(
        max_new_tokens=4, prefill_buckets=(16,), max_batch=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg)
