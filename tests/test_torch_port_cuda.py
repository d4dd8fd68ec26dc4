"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an sm_90 GPU and nvcc and skips elsewhere;
this file imports neither JAX nor the JAX package, so it runs on the
GPU machine as it is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerances: fp32 outputs and gradients differ from the plain version
only by the order of fp32 sums and exp2f's last-bit error (1e-4);
bf16/fp16 outputs and gradients are both rounded from fp32 and may
land one output ulp apart (1e-2 absolute + 1e-2 relative covers one
bf16 ulp, 2^-7 relative at worst).
"""
import shutil

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa

pytestmark = pytest.mark.cuda

_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2),
        torch.float16: (1e-2, 1e-2)}


@pytest.fixture(scope="module")
def dev():
    ok = torch.cuda.is_available() and \
        torch.cuda.get_device_capability(0) >= (9, 0) and \
        (shutil.which("nvcc") is not None
         or __import__("os").path.exists("/usr/local/cuda/bin/nvcc"))
    if not ok:
        pytest.skip("needs an sm_90 GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _close(out, ref):
    atol, rtol = _TOL[out.dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("sq,sk,hq,hk,causal", [
    (100, 100, 4, 4, True),     # ragged self-attention, off the 64 grid
    (37, 100, 4, 2, True),      # cross length + grouped-query heads
    (37, 100, 4, 4, False),
    (130, 64, 2, 2, True),      # sq > sk: leading rows fully masked
    (512, 512, 3, 3, True),
])
def test_flash_fwd_matches_plain(dev, dtype, d, sq, sk, hq, hk, causal):
    gen = torch.Generator(device=dev).manual_seed(sq * 7 + sk + d)
    b = 2
    q = _randn(gen, (b, sq, hq, d), dtype, dev)
    k = _randn(gen, (b, sk, hk, d), dtype, dev)
    v = _randn(gen, (b, sk, hk, d), dtype, dev)
    n0 = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    ref = fa.flash_attention_plain(q, k, v, causal=causal)
    _close(out, ref)
    if causal and sq > sk:
        assert out[:, :sq - sk].abs().max().item() == 0.0


def test_flash_fwd_lse_matches_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    q = _randn(gen, (2, 70, 4, 64), torch.float32, dev)
    k = _randn(gen, (2, 50, 2, 64), torch.float32, dev)
    v = _randn(gen, (2, 50, 2, 64), torch.float32, dev)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True,
                                            return_lse=True)
    _close(out, ref)
    assert torch.isinf(lse[:, :, :20]).all()   # rows before the diagonal
    torch.testing.assert_close(lse[:, :, 20:], ref_lse[:, :, 20:],
                               atol=1e-4, rtol=1e-4)


def test_flash_fwd_reads_strided_qkv_views(dev):
    """The model hands in views of its fused qkv projection."""
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s, h, d = 2, 77, 4, 64
    qkv = _randn(gen, (b, s, 3, h, d), torch.bfloat16, dev)
    q, k, v = qkv.unbind(dim=2)
    out = fa.flash_attention(q, k, v, causal=True)
    ref = fa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True)
    _close(out, ref)


def _misaligned(gen, shape, dtype, dev):
    """A contiguous tensor whose data starts one element past a 16-byte
    boundary: the kernels must take their element-load path."""
    n = int(np.prod(shape))
    return _randn(gen, (n + 1,), dtype, dev)[1:].view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_misaligned_inputs_match_plain(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(9)
    q = _misaligned(gen, (2, 70, 4, 64), dtype, dev)
    k = _misaligned(gen, (2, 90, 2, 64), dtype, dev)
    v = _misaligned(gen, (2, 90, 2, 64), dtype, dev)
    assert q.data_ptr() % 16
    _close(fa.flash_attention(q, k, v, causal=True),
           fa.flash_attention_plain(q, k, v, causal=True))
    kv = torch.tensor([1, 90], dtype=torch.int32, device=dev)
    _close(fa.flash_attention_decode(q[:, :3], k, v, kv),
           fa.flash_attention_decode_plain(q[:, :3], k, v, kv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("sq,hq,hk", [
    (1, 4, 4), (4, 4, 2),       # <= 8 query rows per group: 8-row blocks
    (8, 8, 2), (3, 12, 1),      # 32 and 36 rows: one 64-row block
    (8, 16, 1),                 # 128 rows: two 64-row blocks
])
def test_flash_decode_matches_plain(dev, dtype, d, sq, hq, hk):
    gen = torch.Generator(device=dev).manual_seed(sq * 31 + hq + d)
    b, t = 5, 200
    kv = torch.tensor([sq, sq + 1, 77, t, 130], dtype=torch.int32,
                      device=dev)
    # a layer slice of a [layers, b, t, hk, d] cache, read in place
    cache_k = _randn(gen, (3, b, t, hk, d), dtype, dev)
    cache_v = _randn(gen, (3, b, t, hk, d), dtype, dev)
    q = _randn(gen, (b, sq, hq, d), dtype, dev)
    n0 = fa.flash_attention_decode.launches
    out = fa.flash_attention_decode(q, cache_k[1], cache_v[1], kv)
    torch.cuda.synchronize()
    assert fa.flash_attention_decode.launches == n0 + 1
    ref = fa.flash_attention_decode_plain(q, cache_k[1], cache_v[1], kv)
    _close(out, ref)


def test_flash_decode_parked_lanes(dev):
    """kv_len 0 (a parked slot) reads nothing and writes zeros; kv_len 1
    attends exactly column 0."""
    gen = torch.Generator(device=dev).manual_seed(1)
    b, t, h, d = 3, 128, 2, 64
    k = _randn(gen, (b, t, h, d), torch.bfloat16, dev)
    v = _randn(gen, (b, t, h, d), torch.bfloat16, dev)
    q = _randn(gen, (b, 1, h, d), torch.bfloat16, dev)
    kv = torch.tensor([0, 1, 128], dtype=torch.int32, device=dev)
    out = fa.flash_attention_decode(q, k, v, kv)
    assert out[0].abs().max().item() == 0.0
    torch.testing.assert_close(out[1, 0].float(), v[1, 0].float())
    _close(out, fa.flash_attention_decode_plain(q, k, v, kv))


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros((1, 1, 2, 64), dtype=torch.bfloat16, device=dev)
    c = torch.zeros((1, 16, 2, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError, match="int32"):
        fa.flash_attention_decode(q, c, c, torch.ones(1, dtype=torch.int64,
                                                      device=dev))
    with pytest.raises(ValueError, match="contiguous head_dim"):
        wide = torch.zeros((1, 16, 2, 128), dtype=torch.bfloat16,
                           device=dev)
        fa.flash_attention(q, wide[..., ::2], c)
    with pytest.raises(NotImplementedError, match="head_dim"):
        z = torch.zeros((1, 4, 2, 48), dtype=torch.bfloat16, device=dev)
        fa.flash_attention(z, z, z)
    with pytest.raises(ValueError):
        fa.flash_attention(q, c.cpu(), c.cpu())


def test_model_on_card_matches_model_on_cpu(dev):
    """test-tiny in fp32: the kernel path on the card against the plain
    path on the CPU, prefill and decode logits (1e-4: fp32 sums in other
    orders, cuBLAS against the CPU BLAS)."""
    from paddle_tpu_torch.generation import GenerationSession
    from paddle_tpu_torch.generation.api import GenerationConfig
    from paddle_tpu_torch.models.gpt import gpt
    cpu = gpt("test-tiny", device="cpu",
              generator=torch.Generator().manual_seed(0)).eval()
    gpu = gpt("test-tiny", device=dev).eval()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 512, (3, 40))
    plen = np.array([40, 17, 1])
    toks = rng.randint(0, 512, (4, 3))
    cfg = GenerationConfig()
    outs = []
    for m, d in ((cpu, "cpu"), (gpu, dev)):
        with torch.no_grad():
            logits, cache = m(torch.as_tensor(ids, device=d),
                              use_cache=True,
                              prompt_len=torch.as_tensor(plen, device=d),
                              cache_max_len=64)
            steps = [logits]
            for tok in toks:
                lg, cache = m(torch.as_tensor(tok, device=d)[:, None],
                              cache=cache)
                steps.append(lg)
        outs.append([s.float().cpu() for s in steps])
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)
    sess = GenerationSession(gpu)
    tok, cache, fin = sess.prefill(torch.as_tensor(ids, device=dev),
                                   torch.as_tensor(plen, device=dev),
                                   cfg, 64)
    assert tok.shape == (3,) and not fin.any()


def _bwd_inputs(gen, b, sq, sk, hq, hk, d, dtype, dev):
    q = _randn(gen, (b, sq, hq, d), dtype, dev)
    k = _randn(gen, (b, sk, hk, d), dtype, dev)
    v = _randn(gen, (b, sk, hk, d), dtype, dev)
    do = _randn(gen, (b, sq, hq, d), dtype, dev)
    return q, k, v, do


def _check_bwd(q, k, v, do, causal):
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    n0 = fa.flash_attention_bwd.launches
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == n0 + 1
    ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    for g, r in zip(grads, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        _close(g, r)
    return grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("sq,sk,hq,hk,causal", [
    (100, 100, 4, 4, True),     # ragged self-attention, off every tile grid
    (37, 100, 4, 2, True),      # cross length + grouped-query heads
    (37, 100, 4, 4, False),
    (130, 64, 2, 2, True),      # sq > sk: leading rows fully masked
    (256, 256, 6, 2, True),     # 3 q heads per kv head
])
def test_flash_bwd_matches_plain(dev, dtype, d, sq, sk, hq, hk, causal):
    gen = torch.Generator(device=dev).manual_seed(sq * 5 + sk + d + hq)
    q, k, v, do = _bwd_inputs(gen, 2, sq, sk, hq, hk, d, dtype, dev)
    dq, _, _ = _check_bwd(q, k, v, do, causal)
    if causal and sq > sk:
        assert dq[:, :sq - sk].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_misaligned_and_strided(dev, dtype):
    """Rows off 16-byte alignment take the element-load path; views of
    a fused qkv projection are read through their strides."""
    gen = torch.Generator(device=dev).manual_seed(21)
    q = _misaligned(gen, (2, 70, 4, 64), dtype, dev)
    k = _misaligned(gen, (2, 90, 2, 64), dtype, dev)
    v = _misaligned(gen, (2, 90, 2, 64), dtype, dev)
    do = _misaligned(gen, (2, 70, 4, 64), dtype, dev)
    assert q.data_ptr() % 16
    _check_bwd(q, k, v, do, True)
    qkv = _randn(gen, (2, 77, 3, 4, 64), dtype, dev)
    q, k, v = qkv.unbind(dim=2)
    _check_bwd(q, k, v, _randn(gen, (2, 77, 4, 64), dtype, dev), True)


def test_training_attention_records_the_kernel_backward(dev):
    """On the card, inputs that require a gradient give an output that
    requires one, and its backward launches the backward kernel and no
    plain version."""
    gen = torch.Generator(device=dev).manual_seed(22)
    q, k, v, do = _bwd_inputs(gen, 2, 64, 64, 4, 2, 64, torch.bfloat16, dev)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fa.reset_counts()
    out = fa.flash_attention(q, k, v, causal=True)
    assert out.requires_grad
    assert type(out.grad_fn) is fa._FlashAttentionFn._backward_cls
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == 1
    assert fa.flash_attention_bwd.launches == 1
    assert fa.flash_attention_plain.calls == 0
    assert fa.flash_attention_bwd_plain.calls == 0
    with torch.no_grad():
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    ref = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                       o, lse, do, True)
    for g, r in zip(grads, ref):
        _close(g, r)


def test_train_steps_on_card_match_the_cpu(dev):
    """test-tiny in fp32, three AdamW TrainSteps with the fused chunked
    loss: the kernel path on the card against the plain path on the CPU
    (losses within 1e-4; parameters within 1e-4 — fp32 sums in other
    orders, cuBLAS against the CPU BLAS, then three Adam steps)."""
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.models.gpt import gpt
    kw = dict(fused_lm_loss=True, lm_loss_chunk=16,
              lm_loss_save_logits_budget=0)
    cpu = gpt("test-tiny", device="cpu",
              generator=torch.Generator().manual_seed(0), **kw)
    gpu = gpt("test-tiny", device=dev, **kw)
    gpu.load_state_dict(cpu.state_dict())
    ids = np.random.RandomState(0).randint(0, 512, (3, 50))
    losses = []
    for m in (cpu, gpu):
        opt = optimizer.AdamW(1e-3, parameters=m.parameters())
        step = jit.TrainStep(m, opt, lambda o, y, m=m: m.loss(o, y))
        losses.append([step(ids, ids).item() for _ in range(3)])
    np.testing.assert_allclose(losses[1], losses[0], atol=1e-4)
    for (name, a), b in zip(cpu.state_dict().items(),
                            gpu.state_dict().values()):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4,
                                   msg=name)
