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
    torch.backends.cudnn.allow_tf32 = False     # fp32 plain convolutions
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


def _decode_kv_len(sq, t, dev):
    """Ragged lengths for a [5, t] cache: the window alone, one more, a
    full row, and lengths off the 128-column split grid (past many
    splits of the long caches)."""
    lens = [sq, sq + 1, 77, t, 130] if t < 2048 else \
        [sq, 129, 1000 + sq, t, t - 37]
    return torch.tensor(lens, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("sq,hq,hk", [
    (1, 4, 4), (4, 4, 2),       # 1 and 8 query rows per group
    (8, 8, 2), (3, 12, 1),      # 32 and 36 rows: several 8-row blocks
    (8, 16, 1),                 # 128 rows
])
@pytest.mark.parametrize("t", [200, 2048, 4096])
def test_flash_decode_matches_plain(dev, dtype, d, sq, hq, hk, t):
    gen = torch.Generator(device=dev).manual_seed(sq * 31 + hq + d + t - 200)
    b = 5
    kv = _decode_kv_len(sq, t, dev)
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,sk,hq,hk,causal", [
    (1, 1, 12, 4, True),        # one row, one column
    (1, 1, 6, 2, False),
    (63, 63, 12, 4, True),      # one short of a 64-row tile
    (64, 64, 6, 2, False),      # exactly one tile
    (65, 65, 12, 4, True),      # one row and one column into the next
    (127, 127, 6, 2, True),
    (129, 129, 12, 4, False),
    (63, 129, 12, 4, True),     # cross lengths, diagonal bottom-right
    (65, 127, 12, 12, False),
    (129, 65, 6, 2, True),      # sq > sk: leading rows fully masked
    (127, 1, 6, 2, True),
    (1, 129, 12, 4, True),      # one query row against three key tiles
])
def test_flash_tile_edges_match_plain(dev, dtype, d, sq, sk, hq, hk,
                                      causal):
    """The tensor-core forward and backward at the edges of their
    64-row tiles, grouped-query heads 12:4 and 6:2, every head_dim they
    take, bf16 and fp16."""
    assert fa.route(dtype, d) == "mma"
    gen = torch.Generator(device=dev).manual_seed(sq * 3 + sk + d + hq)
    q, k, v, do = _bwd_inputs(gen, 2, sq, sk, hq, hk, d, dtype, dev)
    _close(fa.flash_attention(q, k, v, causal=causal),
           fa.flash_attention_plain(q, k, v, causal=causal))
    dq, _, _ = _check_bwd(q, k, v, do, causal)
    if causal and sq > sk:
        assert dq[:, :sq - sk].abs().max().item() == 0.0


def test_flash_route_names_the_tensor_cores(dev):
    assert fa.route(torch.bfloat16, 64) == "mma"
    assert fa.route(torch.float16, 128) == "mma"
    assert fa.route(torch.float32, 64) == "fma"
    assert fa.route(torch.bfloat16, 256) == "fma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_repeats_bit_for_bit(dev, dtype):
    """No atomics and no cross-block sums: two calls give the same
    bits, forward and backward."""
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v, do = _bwd_inputs(gen, 2, 300, 300, 12, 4, 64, dtype, dev)
    runs = []
    for _ in range(2):
        out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        runs.append((out, lse, *fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                        True)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_rows_do_not_depend_on_the_batch(dev, dtype):
    """Row b of a batch-4 forward and backward equals, bit for bit, the
    same row run at batch 1: a block's result depends on its own rows
    alone (the serving engine's batch-1 equalities rely on it)."""
    gen = torch.Generator(device=dev).manual_seed(32)
    q, k, v, do = _bwd_inputs(gen, 4, 200, 200, 12, 4, 64, dtype, dev)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
    for b in range(4):
        one = [t[b:b + 1] for t in (q, k, v, do)]
        o1, l1 = fa.flash_attention(*one[:3], causal=True, return_lse=True)
        g1 = fa.flash_attention_bwd(*one[:3], o1, l1, one[3], True)
        assert torch.equal(o1, out[b:b + 1]) and torch.equal(l1, lse[b:b + 1])
        for g, ref in zip(g1, grads):
            assert torch.equal(g, ref[b:b + 1])


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


# ---------------------------------------------- paged decode and chunk


def _paged_from_dense(gen, k, v, page):
    """A pool holding the logical rows of the dense [b, t, hk, d] caches
    k, v in shuffled pages (page 0 the null page, filled with noise),
    as a layer slice of a [2, n_pages, page, hk, d] pool; and the table.
    t need not be a multiple of page: the last page of a row is padded
    with noise."""
    b, t, hk, d = k.shape
    n_slots = -(-t // page)
    n_pages = 1 + b * n_slots
    perm = torch.randperm(b * n_slots, generator=torch.Generator()
                          .manual_seed(page)) + 1
    table = perm.reshape(b, n_slots).to(torch.int32).to(k.device)
    pools = []
    for src in (k, v):
        pool = _randn(gen, (2, n_pages, page, hk, d), src.dtype, src.device)
        flat = pool[1].reshape(n_pages * page, hk, d)
        rows = (table.long()[:, :, None] * page
                + torch.arange(page, device=k.device)).reshape(b, -1)[:, :t]
        flat[rows] = src
        pools.append(pool)
    return pools[0][1], pools[1][1], table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [16, 48, 64, 128])
@pytest.mark.parametrize("sq,hq,hk", [(1, 12, 12), (1, 12, 4), (3, 12, 4),
                                      (8, 12, 4), (8, 4, 4)])
def test_flash_decode_paged_matches_plain_and_dense(dev, dtype, page, sq, hq,
                                                    hk):
    """Against its plain version, and BITWISE equal to the dense decode
    kernel on the same logical rows, at page sizes that do and do not
    divide the 128-column split; kv_len 0 writes zeros."""
    gen = torch.Generator(device=dev).manual_seed(page + sq + hk)
    b, t, d = 6, 384, 64
    k = _randn(gen, (b, t, hk, d), dtype, dev)
    v = _randn(gen, (b, t, hk, d), dtype, dev)
    q = _randn(gen, (b, sq, hq, d), dtype, dev)
    kv = torch.tensor([0, sq, 17, 200, 333, t], dtype=torch.int32,
                      device=dev)
    kp, vp, table = _paged_from_dense(gen, k, v, page)
    fa.reset_counts()
    out = fa.flash_attention_decode_paged(q, kp, vp, table, kv)
    dense = fa.flash_attention_decode(q, k, v, kv)
    torch.cuda.synchronize()
    assert fa.flash_attention_decode_paged.launches == 1
    assert fa.flash_attention_decode_paged_plain.calls == 0
    assert torch.equal(out, dense)
    assert out[0].abs().max().item() == 0.0
    _close(out, fa.flash_attention_decode_paged_plain(q, kp, vp, table, kv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,hq,hk", [(9, 4, 4), (100, 4, 2), (128, 12, 12),
                                      (300, 12, 4)])
def test_flash_chunk_matches_plain(dev, dtype, sq, hq, hk):
    """Windows past the 8-row cap against a [b, 640, hk, d] cache, with
    a row whose kv_len is below sq (its leading rows fully masked give
    zeros), grouped heads spread over several 64-row blocks."""
    gen = torch.Generator(device=dev).manual_seed(sq + hq + hk)
    b, t, d = 3, 640, 64
    cache_k = _randn(gen, (2, b, t, hk, d), dtype, dev)
    cache_v = _randn(gen, (2, b, t, hk, d), dtype, dev)
    q = _randn(gen, (b, sq, hq, d), dtype, dev)
    kv = torch.tensor([sq - 5, sq + 40, t], dtype=torch.int32, device=dev)
    fa.reset_counts()
    out = fa.flash_attention_chunk(q, cache_k[1], cache_v[1], kv)
    torch.cuda.synchronize()
    assert fa.flash_attention_chunk.launches == 1
    assert fa.flash_attention_chunk_plain.calls == 0
    assert fa.flash_attention_decode.launches == 0
    assert out[0, :5].abs().max().item() == 0.0
    _close(out, fa.flash_attention_chunk_plain(q, cache_k[1], cache_v[1], kv))


def test_paged_and_chunked_refuse_what_they_do_not_take(dev):
    q = torch.zeros((2, 1, 4, 64), dtype=torch.bfloat16, device=dev)
    pool = torch.zeros((5, 16, 4, 64), dtype=torch.bfloat16, device=dev)
    kv = torch.ones(2, dtype=torch.int32, device=dev)
    table = torch.ones((2, 2), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="page_table"):
        fa.flash_attention_decode_paged(q, pool, pool, table.long(), kv)
    with pytest.raises(TypeError, match="kv_len"):
        fa.flash_attention_chunk(q, pool[:2], pool[:2], kv.long())
    with pytest.raises(ValueError):
        fa.flash_attention_decode_paged(q, pool, pool, table.cpu(), kv)


@pytest.mark.parametrize("paged", [False, True])
def test_warmup_peak_memory_is_a_row_next_to_the_cache(dev, paged):
    """warmup() runs its programs on a one-row scratch cache: its peak
    allocation over what the engine held before stays under a quarter
    of the live cache of 64 rows (a scratch of the live cache's size
    doubled it). Measured on a second warmup, so that the libraries'
    one-time workspaces (cuBLAS's) are not counted."""
    from paddle_tpu_torch.inference import Config
    from paddle_tpu_torch.models.gpt import gpt
    from paddle_tpu_torch.serving import ServingEngine
    model = gpt("test-tiny", device=dev).eval()
    cfg = (Config().from_layer(model)
           .enable_generation(max_new_tokens=32, prefill_buckets=(16, 64),
                              max_batch=64)
           .enable_serving(**(dict(paged=True, kv_page_size=16)
                              if paged else {})))
    cfg.enable_use_gpu("float32")
    eng = ServingEngine(cfg)
    cache = eng._cache
    live = 2 * cache.k.numel() * cache.k.element_size()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    eng.warmup()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    assert eng._warm and peak < live / 4, (peak, live)
    eng.shutdown()


def test_paged_chunked_engine_on_card_matches_cpu(dev):
    """test-tiny in fp32: the paged engine with chunked prefill on the
    card gives the CPU engine's tokens, through the paged decode, chunk
    and forward kernels and no plain version (16-token chunks: a window
    of 8 or fewer would be a decode-shaped one)."""
    from paddle_tpu_torch.inference import Config
    from paddle_tpu_torch.models.gpt import gpt
    from paddle_tpu_torch.serving import ServingEngine
    cpu = gpt("test-tiny", device="cpu",
              generator=torch.Generator().manual_seed(0)).eval()
    gpu = gpt("test-tiny", device=dev).eval()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, n) for n in (5, 30, 12, 25, 3, 31)]
    outs = []
    for m, on_card in ((cpu, False), (gpu, True)):
        cfg = (Config().from_layer(m)
               .enable_generation(max_new_tokens=8, prefill_buckets=(16, 32),
                                  max_batch=2)
               .enable_serving(paged=True, kv_page_size=8,
                               prefill_chunk_tokens=16))
        if not on_card:
            cfg.disable_gpu()
        else:
            cfg.enable_use_gpu("float32")
        fa.reset_counts()
        eng = ServingEngine(cfg, poll_every=2)
        outs.append([h.tokens for h in eng.serve_forever(iter(prompts))])
        eng._alloc.assert_conserved()
    assert fa.flash_attention_decode_paged.launches > 0
    assert fa.flash_attention_chunk.launches > 0
    assert fa.flash_attention.launches > 0
    assert fa.flash_attention_decode.launches == 0
    assert fa.flash_attention_decode_paged_plain.calls == 0
    assert fa.flash_attention_chunk_plain.calls == 0
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)


# ------------------------------------------------------- int8 KV cache


def _int8_cache(gen, shape, dev, lead=2):
    """int8 k, v [b, t, hk, d] as layer 1 of [lead, b, t, hk, d] caches,
    and their bf16 scales [b, t, hk] as layer slices too, as a
    QuantKVCache holds them."""
    k, v = (torch.randint(-127, 128, (lead,) + shape, generator=gen,
                          device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = ((torch.rand((lead,) + shape[:-1], generator=gen, device=dev)
               * 0.015 + 0.005).bfloat16() for _ in range(2))
    return k[1], v[1], ks[1], vs[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("sq,hq,hk", [
    (1, 12, 12), (1, 12, 4), (3, 12, 4), (8, 4, 4),    # decode
    (9, 4, 4), (100, 4, 2), (128, 12, 12)])            # chunk windows
@pytest.mark.parametrize("t", [200, 2048, 4096])
def test_int8_decode_and_chunk_match_plain(dev, dtype, d, sq, hq, hk, t):
    """The int8 modes against their plain versions: ragged and odd
    kv_len (off the split grid of the long caches), grouped heads, 1..8
    rows (decode) and longer windows (chunk); launches count under the
    int8 names only."""
    gen = torch.Generator(device=dev).manual_seed(
        sq * 7 + hq + hk + d + t - 200)
    b = 4
    k, v, ks, vs = _int8_cache(gen, (b, t, hk, d), dev)
    q = _randn(gen, (b, sq, hq, d), dtype, dev)
    kv = _decode_kv_len(sq, t, dev)[:b]
    fn, plain = (fa.flash_attention_decode, fa.flash_attention_decode_plain) \
        if sq <= fa.MAX_DECODE_QLEN else \
        (fa.flash_attention_chunk, fa.flash_attention_chunk_plain)
    fa.reset_counts()
    out = fn(q, k, v, kv, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert (fn.launches_int8, fn.launches) == (1, 0)
    assert plain.calls_int8 == 0
    _close(out, plain(q, k, v, kv, k_scale=ks, v_scale=vs))


def test_int8_serving_shapes_and_scalar_path(dev):
    """The serving shapes (q [8,1,12,64] bf16, cache [8,640,12,64]), and
    an int8 cache whose base is off a 16-byte boundary (the element-load
    path), against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(5)
    k, v, ks, vs = _int8_cache(gen, (8, 640, 12, 64), dev)
    q = _randn(gen, (8, 1, 12, 64), torch.bfloat16, dev)
    kv = torch.tensor([1, 1, 17, 200, 333, 512, 577, 640], dtype=torch.int32,
                      device=dev)
    _close(fa.flash_attention_decode(q, k, v, kv, k_scale=ks, v_scale=vs),
           fa.flash_attention_decode_plain(q, k, v, kv, k_scale=ks,
                                           v_scale=vs))
    n = 2 * 90 * 2 * 64
    base = torch.randint(-127, 128, (2, n + 1), generator=gen, device=dev,
                         dtype=torch.int8)
    km, vm = (base[i, 1:].view(2, 90, 2, 64) for i in range(2))
    assert km.data_ptr() % 16
    q = _randn(gen, (2, 3, 4, 64), torch.bfloat16, dev)
    kv = torch.tensor([3, 90], dtype=torch.int32, device=dev)
    _close(fa.flash_attention_decode(q, km, vm, kv, k_scale=ks[:2, :90, :2],
                                     v_scale=vs[:2, :90, :2]),
           fa.flash_attention_decode_plain(q, km, vm, kv,
                                           k_scale=ks[:2, :90, :2],
                                           v_scale=vs[:2, :90, :2]))


def _int8_paged_from_dense(gen, k, v, ks, vs, page):
    """The int8 rows and their scales in shuffled pages of one pool (as
    _paged_from_dense), scale pools through the same table."""
    kp, vp, table = _paged_from_dense(gen, k.float(), v.float(), page)
    b, t, hk = ks.shape
    n_pages = kp.shape[0]
    rows = (table.long()[:, :, None] * page
            + torch.arange(page, device=k.device)).reshape(b, -1)[:, :t]
    pools = []
    for src in (ks, vs):
        pool = torch.rand((n_pages * page, hk), generator=gen,
                          device=k.device).bfloat16()
        pool[rows] = src
        pools.append(pool.view(n_pages, page, hk))
    return (kp.round().clamp(-127, 127).to(torch.int8),
            vp.round().clamp(-127, 127).to(torch.int8), pools[0], pools[1],
            table)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [16, 48, 64, 128])
@pytest.mark.parametrize("sq,hq,hk", [(1, 12, 12), (1, 12, 4), (8, 4, 4)])
def test_int8_paged_matches_plain_and_dense(dev, dtype, page, sq, hq, hk):
    """The int8 paged mode against its plain version, and BITWISE equal
    to the int8 dense mode on the same logical rows and scales, at page
    sizes that do and do not divide the 128-column split."""
    gen = torch.Generator(device=dev).manual_seed(page + sq + hk)
    b, t, d = 6, 384, 64
    k, v, ks, vs = _int8_cache(gen, (b, t, hk, d), dev)
    q = _randn(gen, (b, sq, hq, d), dtype, dev)
    kv = torch.tensor([0, sq, 17, 200, 333, t], dtype=torch.int32,
                      device=dev)
    kp, vp, ksp, vsp, table = _int8_paged_from_dense(gen, k, v, ks, vs, page)
    fa.reset_counts()
    out = fa.flash_attention_decode_paged(q, kp, vp, table, kv, k_scale=ksp,
                                          v_scale=vsp)
    dense = fa.flash_attention_decode(q, k, v, kv, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert fa.flash_attention_decode_paged.launches_int8 == 1
    assert fa.flash_attention_decode_paged.launches == 0
    assert torch.equal(out, dense)
    assert out[0].abs().max().item() == 0.0
    _close(out, fa.flash_attention_decode_paged_plain(
        q, kp, vp, table, kv, k_scale=ksp, v_scale=vsp))


def _off16(t):
    """A copy of ``t`` whose data starts one element past a 16-byte
    boundary: the decode kernels take their element-copy path."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 8
    return out


def _decode_call(q, k, v, kv, scales, page=None, gen=None):
    """flash_attention_decode, or with ``page`` flash_attention_decode_paged
    on the same logical rows laid out in shuffled pages."""
    if page is None:
        return fa.flash_attention_decode(q, k, v, kv, **scales)
    if scales:
        kp, vp, ksp, vsp, table = _int8_paged_from_dense(
            gen, k, v, scales["k_scale"], scales["v_scale"], page)
        return fa.flash_attention_decode_paged(q, kp, vp, table, kv,
                                               k_scale=ksp, v_scale=vsp)
    kp, vp, table = _paged_from_dense(gen, k, v, page)
    return fa.flash_attention_decode_paged(q, kp, vp, table, kv)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,hq,hk", [(1, 12, 12), (1, 12, 4), (4, 8, 2)])
def test_decode_bits_depend_on_the_request_alone(dev, int8, dtype, sq, hq,
                                                 hk):
    """One request's output is the same bit for bit at batch 1 and in
    slot 5 of batch 8, at cache capacities 640 and 1024 (5 and 8 splits,
    folded in a cluster) and 2048 (16, folded through scratch), on the
    dense cache and through a page table (page 48): the bits depend on
    its logical rows and kv_len only (577 spans 5 splits, 130 two), not
    on the batch, the slot, the capacity, the layout or the grid."""
    gen = torch.Generator(device=dev).manual_seed(sq + hq + hk + int8)
    d = 64
    for kv_len in (577, 130):
        q1 = _randn(gen, (1, sq, hq, d), dtype, dev)
        if int8:
            rows = _int8_cache(gen, (1, kv_len, hk, d), dev)
        else:
            rows = tuple(_randn(gen, (1, kv_len, hk, d), dtype, dev)
                         for _ in range(2))
        outs = []
        for b, slot in ((1, 0), (8, 5)):
            for t in (640, 1024, 2048):
                if int8:
                    cache = list(_int8_cache(gen, (b, t, hk, d), dev))
                else:
                    cache = [_randn(gen, (b, t, hk, d), dtype, dev)
                             for _ in range(2)]
                for c, r in zip(cache, rows):
                    c[slot, :kv_len] = r[0]
                q = _randn(gen, (b, sq, hq, d), dtype, dev)
                q[slot] = q1[0]
                kv = torch.randint(sq, t + 1, (b,), generator=gen,
                                   device=dev, dtype=torch.int32)
                kv[slot] = kv_len
                scales = dict(k_scale=cache[2], v_scale=cache[3]) \
                    if int8 else {}
                for page in (None, 48):
                    outs.append(_decode_call(q, cache[0], cache[1], kv,
                                             scales, page, gen)[slot])
        torch.cuda.synchronize()
        assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_decode_bits_repeat_and_ignore_alignment(dev, int8, dtype):
    """Two calls give the same bits, dense and paged (page 16), and so
    do copies of the query and cache whose bases are off a 16-byte
    boundary (element copies in place of cp.async); against the plain
    version too."""
    gen = torch.Generator(device=dev).manual_seed(31 + int8)
    b, t, hq, hk, d = 4, 700, 8, 4, 64
    if int8:
        k, v, ks, vs = _int8_cache(gen, (b, t, hk, d), dev)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = (_randn(gen, (b, t, hk, d), dtype, dev) for _ in range(2))
        scales = {}
    q = _randn(gen, (b, 2, hq, d), dtype, dev)
    kv = torch.tensor([2, 129, 640, 700], dtype=torch.int32, device=dev)
    fa.reset_counts()
    for page in (None, 16):
        first = _decode_call(q, k, v, kv, scales, page, gen)
        again = _decode_call(q, k, v, kv, scales, page, gen)
        off = _decode_call(_off16(q), _off16(k), _off16(v), kv, scales,
                           page, gen)
        torch.cuda.synchronize()
        assert torch.equal(first, again) and torch.equal(first, off)
    plain = fa.flash_attention_decode_plain(q, k, v, kv, **scales)
    _close(first, plain)
    launched = (fa.flash_attention_decode.launches_int8,
                fa.flash_attention_decode_paged.launches_int8) if int8 \
        else (fa.flash_attention_decode.launches,
              fa.flash_attention_decode_paged.launches)
    assert launched == (3, 3)


def test_decode_split_constant_and_scratch_check(dev, monkeypatch):
    """Both built decode libraries split at DECODE_SPLIT_KEYS columns, and
    an entry handed less scratch than the rule asks refuses to launch."""
    from paddle_tpu_torch.kernels import _build
    for name, sig in (("flash_decode", fa._DECODE_SIG),
                      ("flash_decode_paged", fa._PAGED_SIG)):
        lib = _build.library(name, sig)
        assert lib.paddle_flash_decode_split_keys() == fa.DECODE_SPLIT_KEYS
    gen = torch.Generator(device=dev).manual_seed(2)
    k, v = (_randn(gen, (2, 1200, 2, 64), torch.bfloat16, dev)
            for _ in range(2))
    q = _randn(gen, (2, 1, 2, 64), torch.bfloat16, dev)
    kv = torch.tensor([5, 1200], dtype=torch.int32, device=dev)
    rule = fa.decode_scratch_floats
    assert rule(2, 1, 2, 2, 1200, 64) == 2 * 2 * 10 * 66
    monkeypatch.setattr(fa, "decode_scratch_floats",
                        lambda *a: rule(*a) - 1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fa.flash_attention_decode(q, k, v, kv)
    monkeypatch.setattr(fa, "decode_scratch_floats", rule)
    _close(fa.flash_attention_decode(q, k, v, kv),
           fa.flash_attention_decode_plain(q, k, v, kv))


def test_layer_norm_rows_do_not_depend_on_the_batch(dev):
    """The port's layer_norm gives a row of a decode step's [8, 1, 768]
    input the bits it gives that row alone (C10: two reductions summed a
    row in another order at batch 8 than at batch 1), in bf16 as the
    model runs it."""
    from paddle_tpu_torch.nn.functional import layer_norm
    gen = torch.Generator(device=dev).manual_seed(10)
    w = (_randn(gen, (768,), torch.float32, dev) * 0.1 + 1).bfloat16()
    b = (_randn(gen, (768,), torch.float32, dev) * 0.1).bfloat16()
    bad = 0
    for _ in range(500):
        x = (_randn(gen, (8, 1, 768), torch.float32, dev) * 3
             + _randn(gen, (8, 1, 1), torch.float32, dev) * 5).bfloat16()
        y = layer_norm(x, (768,), w, b)
        bad += sum(not torch.equal(layer_norm(x[r:r + 1], (768,), w, b)[0],
                                   y[r]) for r in range(8))
    assert bad == 0


def test_rms_norm_rows_do_not_depend_on_the_batch(dev):
    """The port's rms_norm gives a row of an [8, 1, 768] input the bits it
    gives that row alone, in bf16 with a weight and in fp32 without (C10:
    a ``mean`` of the squares summed a row in another order at batch 8
    than at batch 1); and rows of a 16,384 x 768 call (a prefill's rows,
    where the fused kernel's launch may differ) the bits of the same
    rows alone, of the first 8 and of the second half."""
    from paddle_tpu_torch.nn.functional import rms_norm
    gen = torch.Generator(device=dev).manual_seed(11)
    w = (_randn(gen, (768,), torch.float32, dev) * 0.1 + 1).bfloat16()
    bad = 0
    for i in range(500):
        x = (_randn(gen, (8, 1, 768), torch.float32, dev) * 3
             + _randn(gen, (8, 1, 1), torch.float32, dev) * 5)
        dt, wt = (torch.bfloat16, w) if i % 2 == 0 else (torch.float32, None)
        x = x.to(dt)
        y = rms_norm(x, wt)
        bad += sum(not torch.equal(rms_norm(x[r:r + 1], wt)[0], y[r])
                   for r in range(8))
    assert bad == 0
    n = 16384
    for dt, wt in ((torch.bfloat16, w), (torch.float32, None)):
        x = (_randn(gen, (n, 768), torch.float32, dev) * 3
             + _randn(gen, (n, 1), torch.float32, dev) * 5).to(dt)
        y = rms_norm(x, wt)
        bad += sum(not torch.equal(rms_norm(x[r:r + 1], wt)[0], y[r])
                   for r in range(0, n, 257))
        bad += not torch.equal(rms_norm(x[:8], wt), y[:8])
        bad += not torch.equal(rms_norm(x[n // 2:], wt), y[n // 2:])
    assert bad == 0


def test_int8_refuses_what_it_does_not_take(dev):
    """An int8 cache without scales raises on the card as on the CPU;
    scales in another dtype than bf16 raise; nothing launches."""
    gen = torch.Generator(device=dev).manual_seed(3)
    k, v, ks, vs = _int8_cache(gen, (2, 64, 2, 64), dev)
    q = _randn(gen, (2, 1, 2, 64), torch.bfloat16, dev)
    kv = torch.tensor([3, 64], dtype=torch.int32, device=dev)
    fa.reset_counts()
    with pytest.raises(ValueError, match="int8 caches need k_scale"):
        fa.flash_attention_decode(q, k, v, kv)
    with pytest.raises(ValueError, match="int8 caches need k_scale"):
        fa.flash_attention_chunk(q, k, v, kv, k_scale=ks)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention_decode(q, k, v, kv, k_scale=ks.float(),
                                  v_scale=vs.float())
    table = torch.ones((2, 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int8 pools need k_scale"):
        fa.flash_attention_decode_paged(q, k, v, table, kv)
    assert fa.flash_attention_decode.launches_int8 == 0


def test_int8_engines_on_card_match_cpu(dev):
    """test-tiny in fp32 with kv_cache_dtype="int8": the dense engine and
    the paged engine with chunked prefill on the card give the CPU
    engines' tokens, through the int8 kernels and no wide decode-shaped
    kernel or plain version."""
    from paddle_tpu_torch.inference import Config
    from paddle_tpu_torch.models.gpt import gpt
    from paddle_tpu_torch.serving import ServingEngine
    cpu = gpt("test-tiny", device="cpu",
              generator=torch.Generator().manual_seed(0)).eval()
    gpu = gpt("test-tiny", device=dev).eval()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 512, n) for n in (5, 30, 12, 25, 3, 31)]
    for serving in (dict(), dict(paged=True, kv_page_size=8,
                                 prefill_chunk_tokens=16)):
        outs = []
        for m, on_card in ((cpu, False), (gpu, True)):
            cfg = (Config().from_layer(m)
                   .enable_generation(max_new_tokens=8,
                                      prefill_buckets=(16, 32), max_batch=2)
                   .enable_serving(kv_cache_dtype="int8", **serving))
            if not on_card:
                cfg.disable_gpu()
            else:
                cfg.enable_use_gpu("float32")
            fa.reset_counts()
            eng = ServingEngine(cfg, poll_every=2)
            outs.append([h.tokens for h in eng.serve_forever(iter(prompts))])
            assert int(eng._cache.clips) == 0
        launched = [fa.flash_attention_decode.launches_int8,
                    fa.flash_attention_decode_paged.launches_int8,
                    fa.flash_attention_chunk.launches_int8]
        assert launched[1 if serving else 0] > 0
        assert not serving or launched[2] > 0
        assert fa.flash_attention.launches > 0
        assert (fa.flash_attention_decode.launches,
                fa.flash_attention_decode_paged.launches,
                fa.flash_attention_chunk.launches) == (0, 0, 0)
        assert fa.flash_attention_decode_plain.calls_int8 == 0
        assert fa.flash_attention_decode_paged_plain.calls_int8 == 0
        assert fa.flash_attention_chunk_plain.calls_int8 == 0
        for a, b in zip(*outs):
            np.testing.assert_array_equal(b, a)


# ------------------------------------------------ speculative verify windows


@pytest.mark.parametrize("int8", [False, True])
def test_verify_window_at_gpt2_small_heads(dev, int8):
    """A k=4 verify window at gpt2-small's head layout (q [8,5,12,64]
    bf16, cache [8,640,12,64], ragged kv_len, each row attending to its
    own position): the split body's multi-row route against the plain
    version on the dense cache, and through a 128-row page table (the
    41-page pool of the paged engine) bitwise equal to it."""
    gen = torch.Generator(device=dev).manual_seed(16 + int8)
    b, sq, t, h, d = 8, 5, 640, 12, 64
    if int8:
        k, v, ks, vs = _int8_cache(gen, (b, t, h, d), dev)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = (_randn(gen, (b, t, h, d), torch.bfloat16, dev)
                for _ in range(2))
        scales = {}
    q = _randn(gen, (b, sq, h, d), torch.bfloat16, dev)
    kv = torch.tensor([5, 6, 22, 205, 338, 517, 582, 640], dtype=torch.int32,
                      device=dev)
    fa.reset_counts()
    out = fa.flash_attention_decode(q, k, v, kv, **scales)
    paged = _decode_call(q, k, v, kv, scales, 128, gen)
    torch.cuda.synchronize()
    launches = (fa.flash_attention_decode.launches_int8,
                fa.flash_attention_decode_paged.launches_int8) if int8 else \
        (fa.flash_attention_decode.launches,
         fa.flash_attention_decode_paged.launches)
    assert launches == (1, 1)
    assert torch.equal(paged, out)
    _close(out, fa.flash_attention_decode_plain(q, k, v, kv, **scales))


@pytest.mark.parametrize("serving", [dict(), dict(paged=True, kv_page_size=8),
                                     dict(kv_cache_dtype="int8")])
def test_speculative_engine_on_card_matches_cpu(dev, serving):
    """test-tiny in fp32 with speculative="ngram": the engine on the card
    gives the CPU engine's tokens and acceptances, every verify window in
    the decode kernel of its cache, no plain version."""
    from paddle_tpu_torch.inference import Config
    from paddle_tpu_torch.models.gpt import gpt
    from paddle_tpu_torch.serving import ServingEngine
    cpu = gpt("test-tiny", device="cpu",
              generator=torch.Generator().manual_seed(0)).eval()
    gpu = gpt("test-tiny", device=dev).eval()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(2)
    motif = np.tile([11, 7, 42, 99, 3, 5], 5)[:24]
    prompts = [rng.randint(0, 512, n) for n in (5, 30, 12, 3)] + [motif]
    outs, stats = [], []
    for m, on_card in ((cpu, False), (gpu, True)):
        cfg = (Config().from_layer(m)
               .enable_generation(max_new_tokens=8, prefill_buckets=(16, 32),
                                  max_batch=2, speculative="ngram")
               .enable_serving(**serving))
        if not on_card:
            cfg.disable_gpu()
        else:
            cfg.enable_use_gpu("float32")
        eng = ServingEngine(cfg, poll_every=2)
        fa.reset_counts()                # after warmup's one of each
        outs.append([h.tokens for h in eng.serve_forever(iter(prompts))])
        stats.append((eng.stats["spec_proposed"], eng.stats["spec_accepted"]))
    int8 = serving.get("kv_cache_dtype") == "int8"
    kern = fa.flash_attention_decode_paged if serving.get("paged") \
        else fa.flash_attention_decode
    plain = fa.flash_attention_decode_paged_plain if serving.get("paged") \
        else fa.flash_attention_decode_plain
    assert (kern.launches_int8 if int8 else kern.launches) == \
        2 * eng.stats["decode_steps"]
    assert plain.calls == plain.calls_int8 == 0
    assert stats[0] == stats[1] and stats[1][1] > 0
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)


# ------------------------------------------------ fused ResNet (rows 13-16)
#
# Tolerances, per tensor against the plain version on the same inputs:
# rounded outputs (y, dx) within one output ulp of the element plus 1e-3
# of the tensor's largest magnitude (bf16: 2^-7 relative; fp32: 2^-20),
# for fp32 sums taken in another order; the fp32 sums (dw, dscale,
# dshift) within 1e-3 of the tensor's largest magnitude; per channel the
# mean within 1e-3*sqrt(var) + 1e-6 and the var within 1e-3*var + 1e-6.

_ULP = {torch.float32: 2.0 ** -20, torch.bfloat16: 2.0 ** -7}


def _close_scaled(out, ref, ulp=None):
    out, ref = out.float(), ref.float()
    lim = (0.0 if ulp is None else ulp) * ref.abs() \
        + 1e-3 * ref.abs().max()
    bad = ~((out - ref).abs() <= lim)
    assert int(bad.sum()) == 0, float((out - ref).abs().max())


def _close_stats(mean, var, ref_mean, ref_var):
    assert bool(((mean - ref_mean).abs()
                 <= 1e-3 * ref_var.sqrt() + 1e-6).all())
    assert bool(((var - ref_var).abs() <= 1e-3 * ref_var + 1e-6).all())


def _fused_inputs(gen, m, k, n, dtype, dev):
    def r(*shape, s=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * s)
    x = (r(m, k) + 0.5).to(dtype)
    w2 = r(k, n, s=k ** -0.5).to(dtype)
    scale = (r(k).abs() + 0.5)
    shift = r(k, s=0.3)
    return x, w2, scale, shift, r(m, n).to(dtype), r(n), r(n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("m,k,n", [
    (300, 64, 256),      # M off the 128-row tile
    (98, 256, 64),
    (131, 2048, 64),     # deep contraction
    (77, 64, 2048),      # wide output
    (1000, 256, 256),
    (72, 40, 24),        # K, N off the 32-deep slice and 128-wide tile
    # the tile's edges: K = 8, 24, 40 (a 32-deep slice partly empty, a
    # 16-deep mma step half empty), M = 1, 15, 17, 129 (the 16-row
    # fragment, the 128-row tile), N = 8 and 72 (the n8 fragment, a
    # warp's 32 columns)
    (1, 8, 8), (15, 24, 72), (17, 40, 8), (129, 8, 72), (129, 24, 8),
    (17, 72, 40),
    # ResNet-50's stages at full width, conv1 and conv3 (M cut to 3,000
    # rows; layer4's 6,272 whole, several dw chunks)
    (3000, 256, 64), (3000, 64, 256), (3000, 512, 128), (3000, 128, 512),
    (3000, 1024, 256), (3000, 256, 1024), (6272, 2048, 512),
    (6272, 512, 2048),
])
def test_fused_resnet_kernels_match_plain(dev, dtype, prologue, m, k, n):
    from paddle_tpu_torch.kernels import fused_resnet as fr
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    x, w2, scale, shift, dy, dmean, dvar = _fused_inputs(gen, m, k, n, dtype,
                                                         dev)
    fr.reset_counts()
    pro = (scale, shift) if prologue else ()
    fwd = fr.bn_relu_matmul_bn_stats_fwd if prologue \
        else fr.matmul_bn_stats_fwd
    fwd_args = (x, *pro, w2)
    y, mean, var = fwd(*fwd_args)
    again = fwd(*fwd_args)
    torch.cuda.synchronize()
    assert fwd.launches == 2
    assert all(torch.equal(a, b) for a, b in zip((y, mean, var), again))
    plain = fr.bn_relu_matmul_bn_stats_fwd_plain if prologue \
        else fr.matmul_bn_stats_fwd_plain
    ry, rmean, rvar = plain(*fwd_args)
    _close_scaled(y, ry, _ULP[dtype])
    _close_stats(mean, var, rmean, rvar)

    perch, dvar2 = fr._stats_cotangent_coeffs(dmean, dvar, m)
    bwd = fr.bn_relu_matmul_bn_stats_bwd if prologue \
        else fr.matmul_bn_stats_bwd
    bwd_args = (dy, ry, x, *pro, w2, perch, dvar2, rmean)
    grads = bwd(*bwd_args)
    again = bwd(*bwd_args)
    torch.cuda.synchronize()
    assert bwd.launches == 2
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    ref = (fr.bn_relu_matmul_bn_stats_bwd_plain if prologue
           else fr.matmul_bn_stats_bwd_plain)(*bwd_args)
    _close_scaled(grads[0], ref[0], _ULP[dtype])
    for g, r in zip(grads[1:], ref[1:]):
        assert g.dtype == torch.float32
        _close_scaled(g, r)
    # the plain versions ran only where this test called them
    assert [f.calls for f in fr.PLAIN_VERSIONS] == \
        [int(not prologue), int(prologue), int(not prologue), int(prologue),
         0, 0]


def test_fused_resnet_route_names_the_tensor_cores(dev):
    """bf16 products run on mma.sync, fp32 on the CUDA cores, through one
    tile body; the library names the route the entry points take."""
    from paddle_tpu_torch.kernels import fused_resnet as fr
    assert fr.route(torch.bfloat16) == "mma"
    assert fr.route(torch.float32) == "fma"
    with pytest.raises(TypeError):
        fr.route(torch.float16)


def test_fused_resnet_autograd_and_stride2_on_card(dev):
    """conv1x1_bn_stats at stride 2 and bn_relu_conv1x1_bn_stats through
    autograd, all three outputs consumed, against the same graph through
    the plain versions."""
    from unittest import mock
    from paddle_tpu_torch.kernels import fused_resnet as fr
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2, 9, 11, 64), generator=gen, device=dev) \
        .to(torch.bfloat16)
    w_ds = (torch.randn((256, 64, 1, 1), generator=gen, device=dev) / 8) \
        .to(torch.bfloat16)
    w3 = (torch.randn((64, 256, 1, 1), generator=gen, device=dev) / 16) \
        .to(torch.bfloat16)

    def run():
        xs = x.clone().requires_grad_()
        ws, wt = w_ds.clone().requires_grad_(), w3.clone().requires_grad_()
        y, m, v = fr.conv1x1_bn_stats(xs, ws, stride=2)
        assert y.shape == (2, 5, 6, 256)
        s, t = fr.bn_fold(None, None, m, v, 1e-5)
        y3, m3, v3 = fr.bn_relu_conv1x1_bn_stats(y, s, t, wt)
        loss = (y3.float() ** 2).mean() + m3.sum() + 0.5 * v3.sum()
        loss.backward()
        return [loss.detach(), xs.grad, ws.grad, wt.grad]

    fr.reset_counts()
    out = run()
    torch.cuda.synchronize()
    assert [f.launches for f in fr.KERNEL_WRAPPERS] == [1, 1, 1, 1, 0, 0]
    assert [f.calls for f in fr.PLAIN_VERSIONS] == [0] * 6
    with mock.patch.object(fr, "matmul_bn_stats_fwd",
                           fr.matmul_bn_stats_fwd_plain), \
            mock.patch.object(fr, "bn_relu_matmul_bn_stats_fwd",
                              fr.bn_relu_matmul_bn_stats_fwd_plain), \
            mock.patch.object(fr, "matmul_bn_stats_bwd",
                              fr.matmul_bn_stats_bwd_plain), \
            mock.patch.object(fr, "bn_relu_matmul_bn_stats_bwd",
                              fr.bn_relu_matmul_bn_stats_bwd_plain):
        ref = run()
    assert [f.calls for f in fr.PLAIN_VERSIONS] == [1, 1, 1, 1, 0, 0]
    assert abs(float(out[0]) - float(ref[0])) <= 1e-2 * abs(float(ref[0]))
    for g, r in zip(out[1:], ref[1:]):
        g, r = g.float(), r.float()
        assert float((g - r).norm() / r.norm()) < 2e-2
    # the stride-2 rows are the only ones with a gradient
    assert float(out[1][:, 1::2].abs().max()) == 0.0


def test_fused_resnet_kernels_refuse_what_they_do_not_take(dev):
    from paddle_tpu_torch.kernels import fused_resnet as fr
    x = torch.zeros((64, 12), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        fr.matmul_bn_stats_fwd(x, torch.zeros((12, 64), device=dev,
                                              dtype=torch.bfloat16))
    x = torch.zeros((64, 16), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or"):
        fr.matmul_bn_stats_fwd(x, torch.zeros((16, 64), device=dev,
                                              dtype=torch.float16))


# ------------------------------------------------ fused 3x3 (rows 17-18)
#
# The tolerances of rows 13-16 above, per tensor against the plain
# version on the same inputs.

def _conv3x3_inputs(gen, n, h, w, c, o, dtype, dev, shift_off=0.0):
    def r(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s
    x = (r(n, h, w, c) + 0.3).to(dtype)
    scale = r(c).abs() + 0.5
    shift = r(c, s=0.3) + shift_off
    w9 = (r(9 * c, o, s=(9 * c) ** -0.5)
          + torch.linspace(0, 0.1, 9 * c * o, device=dev).reshape(9 * c, o)
          ).to(dtype)
    dy = r(n, h, w, o, s=1e-2).to(dtype)
    return x, scale, shift, w9, dy, r(o), r(o)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,o,shift_off", [
    (2, 5, 7, 8, 16, 0.0),        # H != W, C != O, off every tile
    (2, 6, 6, 16, 8, 0.5),        # positive shift: the border reads 0
    (3, 1, 9, 8, 8, 0.2),         # a 1-pixel-high image
    (2, 3, 150, 24, 40, 0.0),     # W over 128: column tiles
    (5, 14, 14, 96, 72, -0.1),    # ragged bands, channels off 32 and 64
    (8, 7, 7, 512, 512, 0.1),     # layer4's channels
])
def test_conv3x3_kernels_match_plain(dev, dtype, n, h, w, c, o, shift_off):
    from paddle_tpu_torch.kernels import fused_resnet as fr
    gen = torch.Generator(device=dev).manual_seed(n + h + w + c + o)
    x, scale, shift, w9, dy, dmean, dvar = _conv3x3_inputs(
        gen, n, h, w, c, o, dtype, dev, shift_off)
    fr.reset_counts()
    y, mean, var = fr.conv3x3_bn_stats_fwd(x, scale, shift, w9)
    again = fr.conv3x3_bn_stats_fwd(x, scale, shift, w9)
    torch.cuda.synchronize()
    assert fr.conv3x3_bn_stats_fwd.launches == 2
    assert all(torch.equal(a, b) for a, b in zip((y, mean, var), again))
    ry, rmean, rvar = fr.conv3x3_bn_stats_fwd_plain(x, scale, shift, w9)
    _close_scaled(y, ry, _ULP[dtype])
    _close_stats(mean, var, rmean, rvar)

    perch, dvar2 = fr._stats_cotangent_coeffs(dmean, dvar, n * h * w)
    args = (dy, ry, x, scale, shift, w9, perch, dvar2, rmean)
    grads = fr.conv3x3_bn_stats_bwd(*args)
    again = fr.conv3x3_bn_stats_bwd(*args)
    torch.cuda.synchronize()
    assert fr.conv3x3_bn_stats_bwd.launches == 2
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    ref = fr.conv3x3_bn_stats_bwd_plain(*args)
    _close_scaled(grads[0], ref[0], _ULP[dtype])
    for g, r in zip(grads[1:], ref[1:]):
        assert g.dtype == torch.float32
        _close_scaled(g, r)
    # the plain versions ran only where this test called them
    assert [f.calls for f in fr.PLAIN_VERSIONS] == [0, 0, 0, 0, 1, 1]
    assert [f.launches for f in fr.KERNEL_WRAPPERS] == [0, 0, 0, 0, 2, 2]


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_conv3x3_kernels_at_resnet50_layer1(dev, direction):
    """ResNet-50 layer1's 3x3 (64 -> 64 at 56x56) at batch 32, bf16."""
    from paddle_tpu_torch.kernels import fused_resnet as fr
    gen = torch.Generator(device=dev).manual_seed(56)
    x, scale, shift, w9, dy, dmean, dvar = _conv3x3_inputs(
        gen, 32, 56, 56, 64, 64, torch.bfloat16, dev, 0.1)
    ry, rmean, rvar = fr.conv3x3_bn_stats_fwd_plain(x, scale, shift, w9)
    if direction == "forward":
        y, mean, var = fr.conv3x3_bn_stats_fwd(x, scale, shift, w9)
        _close_scaled(y, ry, _ULP[torch.bfloat16])
        _close_stats(mean, var, rmean, rvar)
        return
    perch, dvar2 = fr._stats_cotangent_coeffs(dmean, dvar, 32 * 56 * 56)
    args = (dy, ry, x, scale, shift, w9, perch, dvar2, rmean)
    grads = fr.conv3x3_bn_stats_bwd(*args)
    ref = fr.conv3x3_bn_stats_bwd_plain(*args)
    _close_scaled(grads[0], ref[0], _ULP[torch.bfloat16])
    for g, r in zip(grads[1:], ref[1:]):
        _close_scaled(g, r)


def test_conv3x3_border_is_zero_in_the_activation_domain(dev):
    """shift > 0 makes relu(shift) > 0: the border must still read 0."""
    from paddle_tpu_torch.kernels import fused_resnet as fr
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros((1, 3, 3, 8), device=dev, dtype=dtype)
        scale = torch.ones(8, device=dev)
        shift = torch.full((8,), 0.5, device=dev)
        w9 = torch.zeros((72, 8), device=dev, dtype=dtype)
        w9[:8] = 1.0        # tap (0, 0): the pixel up and left
        y, _, _ = fr.conv3x3_bn_stats_fwd(x, scale, shift, w9)
        assert float(y[0, 0, 0].abs().max()) == 0.0
        assert float((y[0, 1, 1].float() - 4.0).abs().max()) == 0.0


def test_conv3x3_autograd_on_card(dev):
    """bn_relu_conv3x3_bn_stats through autograd, all three outputs
    consumed, against the same graph through the plain versions."""
    from unittest import mock
    from paddle_tpu_torch.kernels import fused_resnet as fr
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((4, 10, 12, 64), generator=gen, device=dev) \
        .to(torch.bfloat16)
    weight = (torch.randn((32, 64, 3, 3), generator=gen, device=dev) / 24) \
        .to(torch.bfloat16)
    scale = torch.rand(64, generator=gen, device=dev) + 0.5
    shift = torch.randn(64, generator=gen, device=dev) * 0.3

    def run():
        xs, ws = x.clone().requires_grad_(), weight.clone().requires_grad_()
        ss, ts = scale.clone().requires_grad_(), shift.clone().requires_grad_()
        y, m, v = fr.bn_relu_conv3x3_bn_stats(xs, ss, ts, ws)
        loss = (y.float() ** 2).mean() + m.sum() + 0.5 * v.sum()
        loss.backward()
        return [loss.detach(), xs.grad, ws.grad, ss.grad, ts.grad]

    fr.reset_counts()
    out = run()
    torch.cuda.synchronize()
    assert [f.launches for f in fr.KERNEL_WRAPPERS] == [0, 0, 0, 0, 1, 1]
    assert [f.calls for f in fr.PLAIN_VERSIONS] == [0] * 6
    with mock.patch.object(fr, "conv3x3_bn_stats_fwd",
                           fr.conv3x3_bn_stats_fwd_plain), \
            mock.patch.object(fr, "conv3x3_bn_stats_bwd",
                              fr.conv3x3_bn_stats_bwd_plain):
        ref = run()
    assert [f.calls for f in fr.PLAIN_VERSIONS] == [0, 0, 0, 0, 1, 1]
    assert abs(float(out[0]) - float(ref[0])) <= 1e-2 * abs(float(ref[0]))
    for g, r in zip(out[1:], ref[1:]):
        g, r = g.float(), r.float()
        assert float((g - r).norm() / r.norm()) < 2e-2


def test_conv3x3_kernels_refuse_what_they_do_not_take(dev):
    from paddle_tpu_torch.kernels import fused_resnet as fr
    fr.reset_counts()
    one = torch.ones(12, device=dev)
    x = torch.zeros((1, 4, 4, 12), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        fr.conv3x3_bn_stats_fwd(x, one, one, torch.zeros(
            (108, 8), device=dev, dtype=torch.bfloat16))
    x = torch.zeros((1, 4, 4, 16), device=dev, dtype=torch.float16)
    one = torch.ones(16, device=dev)
    with pytest.raises(TypeError, match="float32 or"):
        fr.conv3x3_bn_stats_fwd(x, one, one, torch.zeros(
            (144, 8), device=dev, dtype=torch.float16))
    # a refused call launches nothing and runs no plain version
    assert fr.conv3x3_bn_stats_fwd.launches == 0
    assert fr.conv3x3_bn_stats_fwd_plain.calls == 0


# ------------------------------------------------------------ fused norms

def _norm_layout(gen, rows, d, dtype, dev, layout):
    """x [rows, d] on the card: contiguous, one element off a 16-byte
    boundary ("misaligned": the scalar path), rows at a padded stride
    ("strided": the vector path with ld != d) or a transposed view
    ("transposed": copied by the wrapper)."""
    if layout == "misaligned":
        return _randn(gen, (rows * d + 1,), dtype, dev)[1:].view(rows, d)
    if layout == "strided":
        return _randn(gen, (rows, d + 8), dtype, dev)[:, :d]
    if layout == "transposed":
        return _randn(gen, (d, rows), dtype, dev).t()
    return _randn(gen, (rows, d), dtype, dev)


def _norm_pair(dev, rows, d, dtype, rms, layout="contiguous", seed=0):
    """Forward and dx of one norm through the kernels and the plain
    versions on the same inputs; checks the launch counts."""
    from paddle_tpu_torch.kernels import fused_norm as fn
    gen = torch.Generator(device=dev).manual_seed(rows * 31 + d + seed)
    x = _norm_layout(gen, rows, d, dtype, dev, layout) * 2 + 0.5
    dy = _norm_layout(gen, rows, d, dtype, dev, layout)
    w = torch.randn(d, generator=gen, device=dev) * 0.1 + 1.0
    b = torch.randn(d, generator=gen, device=dev) * 0.1
    fn.reset_counts()
    y = fn.norm_fwd(x, w, b, 1e-5, rms)
    dx = fn.norm_dx(x, w, dy, 1e-5, rms)
    torch.cuda.synchronize()
    assert [f.launches for f in fn.KERNEL_WRAPPERS] == [1, 1]
    assert [f.calls for f in fn.PLAIN_VERSIONS] == [0, 0]
    ref_y = fn.norm_fwd_plain(x, w, b, 1e-5, rms)
    ref_dx = fn.norm_dx_plain(x, w, dy, 1e-5, rms)
    assert y.dtype == dx.dtype == dtype
    _close(y, ref_y)
    _close(dx, ref_dx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("d", [64, 768, 1000, 4096])
@pytest.mark.parametrize("rows", [1, 7, 4099, 16384])
def test_fused_norm_kernels_match_plain(dev, dtype, rms, d, rows):
    """4099 rows (a prime) are a multiple of no persistent grid."""
    _norm_pair(dev, rows, d, dtype, rms)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("layout", ["misaligned", "strided", "transposed"])
@pytest.mark.parametrize("rows,d", [(7, 77), (33, 768), (5, 1000),
                                    (9, 4096), (4, 8192), (3, 13000),
                                    (2, 20000)])
def test_fused_norm_kernels_misaligned_and_strided(dev, dtype, layout, rows,
                                                   d):
    """Every kernel variant: odd D (one element at a time), a row per
    warp and per block (8192 bf16: the widest block), rows too wide for
    a block's registers (13000, 20000: re-read)."""
    for rms in (False, True):
        _norm_pair(dev, rows, d, dtype, rms, layout, seed=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16,
                                     torch.float16])
@pytest.mark.parametrize("d", [77, 768, 4096, 20000])
def test_fused_norm_params_in_their_own_dtype(dev, dtype, p_dtype, d):
    """w and b in any of the three dtypes give the bits of the same call
    with ``w.float()`` and ``b.float()``: the kernels widen them exactly."""
    from paddle_tpu_torch.kernels import fused_norm as fn
    gen = torch.Generator(device=dev).manual_seed(d)
    x = _randn(gen, (33, d), dtype, dev) * 2 + 0.5
    dy = _randn(gen, (33, d), dtype, dev)
    w = (torch.randn(d, generator=gen, device=dev) * 0.1 + 1.0).to(p_dtype)
    b = (torch.randn(d, generator=gen, device=dev) * 0.1).to(p_dtype)
    for rms in (False, True):
        fn.reset_counts()
        y = fn.norm_fwd(x, w, b, 1e-5, rms)
        dx = fn.norm_dx(x, w, dy, 1e-5, rms)
        assert [f.launches for f in fn.KERNEL_WRAPPERS] == [1, 1]
        assert torch.equal(y, fn.norm_fwd(x, w.float(), b.float(), 1e-5, rms))
        assert torch.equal(dx, fn.norm_dx(x, w.float(), dy, 1e-5, rms))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [77, 768, 4096, 13000])
def test_fused_norm_rows_do_not_depend_on_the_call(dev, dtype, d):
    """A row's bits depend on D and the dtypes only: the same rows in a
    call of 16384 rows, of 7, of 1, and one element off a 16-byte
    boundary (the one-element loads) are equal bit for bit."""
    from paddle_tpu_torch.kernels import fused_norm as fn
    gen = torch.Generator(device=dev).manual_seed(d + 5)
    x = _randn(gen, (16384, d), dtype, dev) * 2 + 0.5
    dy = _randn(gen, (16384, d), dtype, dev)
    w = torch.randn(d, generator=gen, device=dev) * 0.1 + 1.0
    b = torch.randn(d, generator=gen, device=dev) * 0.1

    def off(t):     # t's values, one element off a 16-byte boundary
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    for rms in (False, True):
        y = fn.norm_fwd(x, w, b, 1e-5, rms)
        dx = fn.norm_dx(x, w, dy, 1e-5, rms)
        for n in (7, 1):
            assert torch.equal(fn.norm_fwd(x[:n], w, b, 1e-5, rms), y[:n])
            assert torch.equal(fn.norm_dx(x[:n], w, dy[:n], 1e-5, rms),
                               dx[:n])
        assert torch.equal(fn.norm_fwd(off(x[:7]), w, b, 1e-5, rms), y[:7])
        assert torch.equal(fn.norm_dx(off(x[:7]), w, off(dy[:7]), 1e-5, rms),
                           dx[:7])


@pytest.mark.parametrize("d", [768, 4096])
def test_fused_norm_one_launch_per_call_in_bf16(dev, d):
    """With x, w and b in bf16, each wrapper call runs one kernel on the
    card and nothing else (no cast of w or b)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.kernels import fused_norm as fn
    gen = torch.Generator(device=dev).manual_seed(d)
    x, dy = (_randn(gen, (256, d), torch.bfloat16, dev) for _ in range(2))
    w, b = (_randn(gen, (d,), torch.bfloat16, dev) for _ in range(2))
    calls = {"norm_fwd_rows": lambda rms: fn.norm_fwd(x, w, b, 1e-5, rms),
             "norm_dx_rows": lambda rms: fn.norm_dx(x, w, dy, 1e-5, rms)}
    for name, call in calls.items():
        for rms in (False, True):
            call(rms)                      # built and loaded
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                call(rms)
                torch.cuda.synchronize()
            kernels = [e.name for e in prof.events()
                       if e.device_type == DeviceType.CUDA]
            assert len(kernels) == 1 and name in kernels[0], kernels


def test_fused_norm_autograd_on_card(dev):
    """fused_layer_norm / fused_rms_norm through autograd on the card
    against the same graph on the CPU."""
    from paddle_tpu_torch.kernels import fused_norm as fn
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((4, 50, 768), generator=gen, device=dev)
    w = torch.randn(768, generator=gen, device=dev) * 0.1 + 1.0
    b = torch.randn(768, generator=gen, device=dev) * 0.1
    ct = torch.randn((4, 50, 768), generator=gen, device=dev)
    for rms in (False, True):
        outs = []
        for d in (dev, torch.device("cpu")):
            xs, ws, bs = (t.detach().to(d).requires_grad_()
                          for t in (x, w, b))
            y = fn.fused_rms_norm(xs, ws) if rms else \
                fn.fused_layer_norm(xs, ws, bs)
            y.backward(ct.to(d))
            outs.append([y.detach(), xs.grad, ws.grad,
                         None if rms else bs.grad])
        for got, ref in zip(*outs):
            assert (got is None) == (ref is None)
            if ref is not None:
                torch.testing.assert_close(got.cpu(), ref, atol=1e-4,
                                           rtol=1e-4)


# ------------------------------------------------------------ fused AdamW

@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float32)])
@pytest.mark.parametrize("n", [1, 7, 1003, 50257 * 3 + 1])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("tensors", [False, True])
def test_fused_adamw_bitwise_equal_to_plain(dev, p_dtype, g_dtype, n,
                                            offset, tensors):
    """Three steps, kernel and plain version from the same state: equal
    bit for bit. ``offset`` 1 starts every array one element off its
    allocation (the one-value path); n % 4 != 0 exercises the tail."""
    from paddle_tpu_torch.kernels import fused_adamw as fa_
    gen = torch.Generator(device=dev).manual_seed(n + offset)

    def arr(dtype, s=1.0):
        t = torch.randn(n + offset, generator=gen, device=dev) * s
        return t.to(dtype)[offset:]

    p, m, v = arr(p_dtype), arr(torch.float32, 0.01), arr(torch.float32, 0.01)
    v.square_()                 # in place: the view keeps its offset
    state = [(p.clone(), m.clone(), v.clone()) for _ in range(2)]
    fa_.reset_counts()
    for step in (1, 2, 3):
        g = arr(g_dtype)
        lr, t = 1e-3 / step, step
        if tensors:
            lr = torch.tensor(lr, device=dev)
            t = torch.tensor(float(t), device=dev)
        fa_.fused_adamw_update(state[0][0], g, state[0][1], state[0][2], lr,
                               0.9, 0.999, 1e-8, 0.01, t)
        fa_.fused_adamw_update_plain(state[1][0], g, state[1][1],
                                     state[1][2], lr, 0.9, 0.999, 1e-8,
                                     0.01, t)
    torch.cuda.synchronize()
    assert fa_.fused_adamw_update.launches == 3
    assert fa_.fused_adamw_update_plain.calls == 3
    for a, b_ in zip(*state):
        assert torch.equal(a, b_)
    assert not torch.equal(state[0][1], m)      # the moments did move


def test_fused_adamw_refuses_what_it_does_not_take(dev):
    from paddle_tpu_torch.kernels import fused_adamw as fa_
    fa_.reset_counts()
    z = dict(device=dev)
    p, g = torch.zeros((4, 6), **z), torch.zeros((4, 6), **z)
    m, v = torch.zeros((4, 6), **z), torch.zeros((4, 6), **z)
    args = (1e-3, 0.9, 0.999, 1e-8, 0.01, 1)
    with pytest.raises(TypeError, match="v must be float32"):
        fa_.fused_adamw_update(p, g, m, v.bfloat16(), *args)
    with pytest.raises(ValueError, match="param's shape"):
        fa_.fused_adamw_update(p, torch.zeros((6, 4), **z), m, v, *args)
    with pytest.raises(ValueError, match="contiguous"):
        fa_.fused_adamw_update(p, g, torch.zeros((6, 4), **z).t(), v, *args)
    with pytest.raises(ValueError, match="is on"):
        fa_.fused_adamw_update(p, g, torch.zeros((4, 6)), v, *args)
    assert fa_.fused_adamw_update.launches == 0
    assert fa_.fused_adamw_update_plain.calls == 0


def test_fused_norm_kernels_refuse_what_they_do_not_take(dev):
    from paddle_tpu_torch.kernels import fused_norm as fn
    fn.reset_counts()
    x = torch.zeros((4, 8), device=dev, dtype=torch.float64)
    one = torch.ones(8, device=dev)
    with pytest.raises(TypeError, match="float32, bfloat16"):
        fn.norm_fwd(x, one, one, 1e-5, False)
    with pytest.raises(ValueError, match="inputs on"):
        fn.norm_fwd(x.float(), one.cpu(), one, 1e-5, False)
    with pytest.raises(TypeError, match="dy2"):
        fn.norm_dx(x.float(), one, x.bfloat16(), 1e-5, True)
    assert [f.launches for f in fn.KERNEL_WRAPPERS] == [0, 0]
    assert [f.calls for f in fn.PLAIN_VERSIONS] == [0, 0]


# ------------------------------------------------------------ fused CE

def _ce_inputs(dev, n, hd, vocab, dtype, vocab_major, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = _randn(gen, (n, hd), dtype, dev)
    w = (torch.randn((vocab, hd), generator=gen, device=dev) * 0.1).to(dtype)
    if not vocab_major:
        w = w.t().contiguous()
    y = torch.randint(0, vocab, (n,), generator=gen, device=dev)
    y[::7] = -1
    if n > 3:
        y[3] = -100
    if n > 5:
        y[5] = vocab + 7           # past the vocabulary: gold 0, ce = lse
    dce = torch.rand((n,), generator=gen, device=dev)
    return h, w, y, dce


def _ce_close(out, ref, grad):
    """ce and lse within 1e-4 (fp32 statistics in another order); dh and
    dW by the training rule (one element ulp plus 1e-3 of the tensor's
    largest magnitude), fp32 within 1e-4."""
    if not grad or out.dtype == torch.float32:
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-4,
                                   rtol=1e-4)
        return
    diff = (out.float() - ref.float()).abs()
    lim = 2.0 ** -7 * ref.float().abs() + 1e-3 * ref.float().abs().max()
    assert bool((diff <= lim).all()), float(diff.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vocab_major", [True, False])
@pytest.mark.parametrize("n,hd,vocab", [(1, 8, 1), (70, 32, 150),
                                        (333, 768, 1001), (130, 200, 517),
                                        (64, 64, 64),
                                        # the bf16 forward's splits left
                                        # empty (V under 8 tiles of 256;
                                        # the last tile's second 128
                                        # columns cut or past V), N
                                        # ragged to its 128-row tiles
                                        (129, 64, 1), (257, 104, 129),
                                        (383, 768, 1000), (255, 64, 1025)])
def test_fused_ce_kernels_match_plain(dev, dtype, vocab_major, n, hd, vocab):
    from paddle_tpu_torch.kernels import fused_ce as fc
    h, w, y, dce = _ce_inputs(dev, n, hd, vocab, dtype, vocab_major)
    fc.reset_counts()
    lse, ce = fc.ce_fwd(h, w, y, vocab_major)
    dh, dw = fc.ce_bwd(h, w, y, lse, dce, vocab_major)
    again = fc.ce_fwd(h, w, y, vocab_major) + \
        fc.ce_bwd(h, w, y, lse, dce, vocab_major)
    torch.cuda.synchronize()
    assert (fc.ce_fwd.launches, fc.ce_bwd.launches) == (2, 4)
    assert (fc.ce_fwd_plain.calls, fc.ce_bwd_plain.calls) == (0, 0)
    for a, b in zip((lse, ce, dh, dw), again):
        assert torch.equal(a, b)
    assert dh.dtype == dtype and dw.dtype == dtype
    assert tuple(dw.shape) == tuple(w.shape)
    lse_p, ce_p = fc.ce_fwd_plain(h, w, y, vocab_major)
    dh_p, dw_p = fc.ce_bwd_plain(h, w, y, lse_p, dce, vocab_major)
    _ce_close(lse, lse_p, False)
    _ce_close(ce, ce_p, False)
    _ce_close(dh, dh_p, True)
    _ce_close(dw, dw_p, True)
    ignored = y < 0
    assert bool((ce[ignored] == 0).all() and (dh[ignored] == 0).all())


def test_fused_ce_autograd_on_card_matches_cpu(dev):
    from paddle_tpu_torch.kernels import fused_ce as fc
    from paddle_tpu_torch.kernels import fused_linear_ce
    h, w, y, dce = _ce_inputs(dev, 97, 64, 300, torch.float32, True, seed=3)
    outs = []
    for d in (dev, torch.device("cpu")):
        fc.reset_counts()
        hg = h.detach().to(d).requires_grad_()
        wg = w.detach().to(d).requires_grad_()
        ce = fused_linear_ce(hg, wg, y.to(d))
        (ce * dce.to(d)).sum().backward()
        outs.append((ce.detach().cpu(), hg.grad.cpu(), wg.grad.cpu()))
        if d.type == "cuda":    # the card pass ran the kernels only
            assert [f.launches for f in fc.KERNEL_WRAPPERS] == [1, 2]
            assert [f.calls for f in fc.PLAIN_VERSIONS] == [0, 0]
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_fused_ce_kernels_refuse_what_they_do_not_take(dev):
    from paddle_tpu_torch.kernels import fused_ce as fc
    fc.reset_counts()
    y = torch.zeros((4,), dtype=torch.long, device=dev)
    with pytest.raises(TypeError, match="one dtype"):
        fc.ce_fwd(torch.zeros((4, 8), device=dev),
                  torch.zeros((10, 8), device=dev, dtype=torch.bfloat16), y)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fc.ce_fwd(torch.zeros((4, 8), device=dev, dtype=torch.float16),
                  torch.zeros((10, 8), device=dev, dtype=torch.float16), y)
    with pytest.raises(ValueError, match="inputs on"):
        fc.ce_fwd(torch.zeros((4, 8), device=dev), torch.zeros((10, 8)), y)
    assert [f.launches for f in fc.KERNEL_WRAPPERS] == [0, 0]
    assert [f.calls for f in fc.PLAIN_VERSIONS] == [0, 0]


# ------------------------------------------------ tensor-core chunk kernel
#
# The serving rule (1e-2 + 1e-2 |plain| in bf16 and fp16): the kernel
# rounds P to the query's type once before P V.

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("sq", [9, 100, 128])
@pytest.mark.parametrize("hq,hk", [(4, 2), (12, 12)])
def test_flash_chunk_mma_matches_plain(dev, dtype, int8, sq, hq, hk):
    """The tensor-core chunk kernel against its plain version, wide and
    int8, at kv_len = sq, 256, 512 and a ragged limit (one row below sq:
    its leading rows see nothing and give zeros), read through a layer
    slice of a [2, b, 640, hk, 64] cache; two calls give the same bits,
    and each row the bits of a batch-1 call."""
    gen = torch.Generator(device=dev).manual_seed(sq * 3 + hq + hk + int8)
    b, t, d = 5, 640, 64
    if int8:
        k, v, ks, vs = _int8_cache(gen, (b, t, hk, d), dev)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k = _randn(gen, (2, b, t, hk, d), dtype, dev)[1]
        v = _randn(gen, (2, b, t, hk, d), dtype, dev)[1]
        scales = {}
    q = _randn(gen, (b, sq, hq, d), dtype, dev)
    kv = torch.tensor([sq, 256, 512, sq - 3, 333], dtype=torch.int32,
                      device=dev)
    assert fa.chunk_route(dtype, d) == "mma"
    fa.reset_counts()
    out = fa.flash_attention_chunk(q, k, v, kv, **scales)
    again = fa.flash_attention_chunk(q, k, v, kv, **scales)
    one = fa.flash_attention_chunk(
        q[3:4], k[3:4], v[3:4], kv[3:4],
        **{n: sc[3:4] for n, sc in scales.items()})
    torch.cuda.synchronize()
    launches = fa.flash_attention_chunk.launches_int8 if int8 else \
        fa.flash_attention_chunk.launches
    assert launches == 3
    assert (fa.flash_attention_chunk_plain.calls,
            fa.flash_attention_chunk_plain.calls_int8) == (0, 0)
    assert torch.equal(out, again) and torch.equal(out[3:4], one)
    assert out[3, :3].abs().max().item() == 0.0
    _close(out, fa.flash_attention_chunk_plain(q, k, v, kv, **scales))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [16, 32, 128])
def test_flash_chunk_mma_other_head_dims(dev, dtype, d):
    gen = torch.Generator(device=dev).manual_seed(d)
    b, t, sq, hq, hk = 2, 300, 70, 6, 3
    k = _randn(gen, (b, t, hk, d), dtype, dev)
    v = _randn(gen, (b, t, hk, d), dtype, dev)
    q = _randn(gen, (b, sq, hq, d), dtype, dev)
    kv = torch.tensor([sq + 11, t], dtype=torch.int32, device=dev)
    _close(fa.flash_attention_chunk(q, k, v, kv),
           fa.flash_attention_chunk_plain(q, k, v, kv))
    ki, vi, ks, vs = _int8_cache(gen, (b, t, hk, d), dev)
    _close(fa.flash_attention_chunk(q, ki, vi, kv, k_scale=ks, v_scale=vs),
           fa.flash_attention_chunk_plain(q, ki, vi, kv, k_scale=ks,
                                          v_scale=vs))


def test_flash_chunk_mma_misaligned_cache(dev):
    """A cache whose rows are not 16-byte aligned takes the element
    loads."""
    gen = torch.Generator(device=dev).manual_seed(4)
    k = _misaligned(gen, (2, 90, 2, 64), torch.bfloat16, dev)
    v = _misaligned(gen, (2, 90, 2, 64), torch.bfloat16, dev)
    q = _randn(gen, (2, 20, 4, 64), torch.bfloat16, dev)
    kv = torch.tensor([25, 90], dtype=torch.int32, device=dev)
    _close(fa.flash_attention_chunk(q, k, v, kv),
           fa.flash_attention_chunk_plain(q, k, v, kv))


def test_flash_chunk_route_names_the_tensor_cores(dev):
    assert fa.chunk_route(torch.bfloat16, 64) == "mma"
    assert fa.chunk_route(torch.float16, 16) == "mma"
    assert fa.chunk_route(torch.float32, 64) == "fma"
    assert fa.chunk_route(torch.bfloat16, 256) == "fma"


# ---------------------------------------- fused 3x3 backward, both routes

@pytest.mark.parametrize("route", ["window", "gemm"])
@pytest.mark.parametrize("n,h,w,c,o", [
    (32, 56, 56, 64, 64),       # ResNet-50 layer1's 3x3 at batch 32
    (16, 28, 28, 128, 128),     # layer2
    (32, 14, 14, 256, 256),     # layer3
    (64, 7, 7, 512, 512),       # layer4
])
def test_conv3x3_backward_routes_at_resnet50_shapes(dev, route, n, h, w, c,
                                                    o):
    """Each route of row 18 against the plain version by the training
    rule, in bf16, its bits repeated; the wrapper's own route among them."""
    from paddle_tpu_torch.kernels import fused_resnet as fr
    gen = torch.Generator(device=dev).manual_seed(h + c)
    x, scale, shift, w9, dy, dmean, dvar = _conv3x3_inputs(
        gen, n, h, w, c, o, torch.bfloat16, dev, 0.1)
    ry, rmean, _ = fr.conv3x3_bn_stats_fwd_plain(x, scale, shift, w9)
    perch, dvar2 = fr._stats_cotangent_coeffs(dmean, dvar, n * h * w)
    args = (dy, ry, x, scale, shift, w9, perch, dvar2, rmean)
    grads = fr._launch_bwd3(*args, route)
    again = fr._launch_bwd3(*args, route)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    ref = fr.conv3x3_bn_stats_bwd_plain(*args)
    _close_scaled(grads[0], ref[0], _ULP[torch.bfloat16])
    for g, r in zip(grads[1:], ref[1:]):
        _close_scaled(g, r)


@pytest.mark.parametrize("n,h,w,c,o", [(3, 7, 5, 128, 136),
                                       (2, 9, 9, 136, 128)])
def test_conv3x3_gemm_route_fp32_and_ragged(dev, n, h, w, c, o):
    """The GEMM route in fp32 (its indexing at one fp32 ulp) at shapes off
    its tiles: pixels off 128, channels off 32 and 128."""
    from paddle_tpu_torch.kernels import fused_resnet as fr
    gen = torch.Generator(device=dev).manual_seed(n * h * w)
    x, scale, shift, w9, dy, dmean, dvar = _conv3x3_inputs(
        gen, n, h, w, c, o, torch.float32, dev, 0.2)
    ry, rmean, _ = fr.conv3x3_bn_stats_fwd_plain(x, scale, shift, w9)
    perch, dvar2 = fr._stats_cotangent_coeffs(dmean, dvar, n * h * w)
    args = (dy, ry, x, scale, shift, w9, perch, dvar2, rmean)
    assert fr._conv3x3_route(h, w, c, o) == "gemm"
    fr.reset_counts()
    grads = fr.conv3x3_bn_stats_bwd(*args)
    assert fr.conv3x3_bn_stats_bwd.launches == 1
    ref = fr.conv3x3_bn_stats_bwd_plain(*args)
    _close_scaled(grads[0], ref[0], _ULP[torch.float32])
    for g, r in zip(grads[1:], ref[1:]):
        _close_scaled(g, r)


# ------------------------------------------- fused CE at any hidden size

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vocab_major", [True, False])
@pytest.mark.parametrize("hd", [100, 1024, 1600])
@pytest.mark.parametrize("n,vocab", [(150, 1001), (129, 1), (257, 129),
                                     (383, 1000)])
def test_fused_ce_any_hidden_size_matches_plain(dev, dtype, vocab_major,
                                                hd, n, vocab):
    """Hidden sizes past one 768-column slice (fp32: streamed in slices;
    bf16: 64-deep TMA slices, zeros past H) and off a multiple of 8
    (zero-padded by the wrapper), by the fused-CE rule, with the bf16
    forward's splits left empty (V under 8 tiles) and N ragged to its
    128-row tiles; bits repeat, one launch a call, no plain call, ignored
    rows 0."""
    from paddle_tpu_torch.kernels import fused_ce as fc
    # the first pair keeps its seed; the others each take their own
    seed = hd if (n, vocab) == (150, 1001) else hd + vocab
    h, w, y, dce = _ce_inputs(dev, n, hd, vocab, dtype, vocab_major,
                              seed=seed)
    fc.reset_counts()
    lse, ce = fc.ce_fwd(h, w, y, vocab_major)
    dh, dw = fc.ce_bwd(h, w, y, lse, dce, vocab_major)
    again = fc.ce_fwd(h, w, y, vocab_major) + \
        fc.ce_bwd(h, w, y, lse, dce, vocab_major)
    torch.cuda.synchronize()
    assert (fc.ce_fwd.launches, fc.ce_bwd.launches) == (2, 4)
    assert (fc.ce_fwd_plain.calls, fc.ce_bwd_plain.calls) == (0, 0)
    for a, b in zip((lse, ce, dh, dw), again):
        assert torch.equal(a, b)
    assert tuple(dh.shape) == tuple(h.shape)
    assert tuple(dw.shape) == tuple(w.shape)
    lse_p, ce_p = fc.ce_fwd_plain(h, w, y, vocab_major)
    dh_p, dw_p = fc.ce_bwd_plain(h, w, y, lse_p, dce, vocab_major)
    _ce_close(lse, lse_p, False)
    _ce_close(ce, ce_p, False)
    _ce_close(dh, dh_p, True)
    _ce_close(dw, dw_p, True)
    ignored = y < 0
    assert bool((ce[ignored] == 0).all() and (dh[ignored] == 0).all())


def test_fused_ce_forward_rows_do_not_depend_on_their_neighbours(dev):
    """At gpt2-small's LM head (h [16368, 768], W [50257, 768] bf16) a
    row's lse and ce are bitwise the same alone, inside the whole call
    and inside a 300-row call at another offset within its 128-row tile:
    each row's logits, statistics and fold depend on its own h row, W
    and label only."""
    from paddle_tpu_torch.kernels import fused_ce as fc
    n, hd, vocab = 16368, 768, 50257
    gen = torch.Generator(device=dev).manual_seed(15)
    h = _randn(gen, (n, hd), torch.bfloat16, dev)
    w = (torch.randn((vocab, hd), generator=gen, device=dev)
         * 0.02).bfloat16()
    y = torch.randint(0, vocab, (n,), generator=gen, device=dev)
    y[::7] = -1
    lse, ce = fc.ce_fwd(h, w, y)
    part = fc.ce_fwd(h[8000:8300].contiguous(), w, y[8000:8300])
    for i in (0, 5, 127, 128, 8191, 8299, 16367):
        alone = fc.ce_fwd(h[i:i + 1].contiguous(), w, y[i:i + 1])
        assert torch.equal(alone[0][0], lse[i]), i
        assert torch.equal(alone[1][0], ce[i]), i
    assert torch.equal(part[0], lse[8000:8300])
    assert torch.equal(part[1], ce[8000:8300])


@pytest.mark.parametrize("vocab_major", [True, False])
def test_fused_ce_forward_large_logits_match_plain(dev, vocab_major):
    """Logits of large size: h and W of unit scale at H 768 (a logit's
    spread about 28, a row's largest about 130), where the bf16 forward's
    e^(x - m) as 2^(x log2 e - m log2 e) errs most; lse and ce by the LSE
    rule against the plain version at gpt2-small's vocabulary (every
    split full), ignored rows 0, one launch."""
    from paddle_tpu_torch.kernels import fused_ce as fc
    n, hd, vocab = 383, 768, 50257
    gen = torch.Generator(device=dev).manual_seed(16)
    h = _randn(gen, (n, hd), torch.bfloat16, dev)
    w = _randn(gen, (vocab, hd), torch.bfloat16, dev)
    if not vocab_major:
        w = w.t().contiguous()
    y = torch.randint(0, vocab, (n,), generator=gen, device=dev)
    y[::7] = -1
    fc.reset_counts()
    lse, ce = fc.ce_fwd(h, w, y, vocab_major)
    assert (fc.ce_fwd.launches, fc.ce_fwd_plain.calls) == (1, 0)
    lse_p, ce_p = fc.ce_fwd_plain(h, w, y, vocab_major)
    assert float(lse_p.max()) > 100.0       # the logits are large
    _ce_close(lse, lse_p, False)
    _ce_close(ce, ce_p, False)
    assert bool((ce[y < 0] == 0).all())


# ------------------------------ fused CE backward on three products

# chip_smoke.py's _CE_SHAPES: (N, H, V, dtype, vocab_major)
_CE_SMOKE_SHAPES = [(16368, 768, 50257, torch.bfloat16, True),
                    (4093, 768, 50257, torch.bfloat16, False),
                    (2045, 768, 8191, torch.float32, True),
                    (4093, 1024, 50257, torch.bfloat16, True),
                    (2045, 1600, 50257, torch.bfloat16, False),
                    (1027, 100, 8191, torch.float32, True)]
_VC = 8192   # kernels/fused_ce.py's _CHUNK_V


@pytest.mark.parametrize("n,hd,vocab,dtype,vocab_major", _CE_SMOKE_SHAPES + [
    (300, 64, _VC - 1, torch.bfloat16, True),    # chunk edges: inside,
    (300, 64, _VC, torch.bfloat16, True),        # on and past a tile
    (300, 64, _VC + 1, torch.bfloat16, False),
    (300, 64, 2 * _VC - 1, torch.float32, True),
    (300, 64, 2 * _VC, torch.bfloat16, True),
    (300, 64, 2 * _VC + 1, torch.float32, False),
    (257, 100, 2 * _VC + 1, torch.bfloat16, True),
    (257, 1024, _VC + 129, torch.bfloat16, False),
    (257, 1600, _VC + 127, torch.float32, True),
])
def test_fused_ce_backward_chunks_match_plain(dev, n, hd, vocab, dtype,
                                              vocab_major):
    """Row 12 (three products over vocabulary chunks) against the plain
    version by the fused-CE rule, at chip_smoke.py's shapes and with V on
    and on either side of a chunk edge, on chip_smoke.py's data (W at
    gpt2's 0.02 scale, the cotangent of a mean over the rows; at larger
    logits see the fp64 test below): launches two a chunk, bits
    repeated, ignored rows' dh exactly 0, and the call's peak memory over
    its inputs within the planned scratch plus dh and dW."""
    from paddle_tpu_torch.kernels import fused_ce as fc
    h, w, y, dce = _ce_inputs(dev, n, hd, vocab, dtype, vocab_major,
                              seed=vocab % 97)
    w, dce = (w.float() * 0.2).to(dtype), dce / n
    lse, _ = fc.ce_fwd(h, w, y, vocab_major)
    torch.cuda.synchronize()
    fc.reset_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dh, dw = fc.ce_bwd(h, w, y, lse, dce, vocab_major)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    hd8 = -(-hd // 8) * 8
    vc, chunks, scratch = fc.ce_bwd_plan(n, vocab, hd8, h.element_size())
    assert fc.ce_bwd.launches == 2 * chunks
    assert (fc.ce_fwd_plain.calls, fc.ce_bwd_plain.calls) == (0, 0)
    # scratch, dh and dW (twice over where the wrapper transposes or pads
    # them), the padded or transposed operands, and N-sized vectors
    outs = (n + vocab) * hd8 * h.element_size()
    copies = 0 if vocab_major and hd8 == hd else outs
    assert peak <= scratch + 2 * outs + copies + 64 * n + 2 ** 20, peak
    again = fc.ce_bwd(h, w, y, lse, dce, vocab_major)
    torch.cuda.synchronize()
    assert torch.equal(dh, again[0]) and torch.equal(dw, again[1])
    assert bool((dh[y < 0] == 0).all())
    dh_p, dw_p = fc.ce_bwd_plain(h, w, y, lse, dce, vocab_major)
    _ce_close(dh, dh_p, True)
    _ce_close(dw, dw_p, True)


@pytest.mark.parametrize("n,hd,vocab,dtype,vocab_major",
                         [s for s in _CE_SMOKE_SHAPES if s[2] > _VC])
def test_fused_ce_backward_is_as_close_to_fp64_as_plain(dev, n, hd, vocab,
                                                        dtype, vocab_major):
    """At the default data (W at 0.1, unscaled cotangents: logits of std
    3-4, gold-column d near 1) and every shape of chip_smoke.py with more
    than one chunk, a d that lies on a bf16 rounding boundary may round
    the other way in the kernel and in the plain version (their fp32
    logits are summed in another order), and one such flip moves a dh
    element by up to |W| * 2^-8, past 1e-3 of the largest dh. So both
    are held to an fp64 reference that rounds d to bf16 as they do: the
    kernel's mean error within 1.05x the plain version's, its largest
    within 1.1x."""
    from paddle_tpu_torch.kernels import fused_ce as fc
    h, w, y, dce = _ce_inputs(dev, n, hd, vocab, dtype, vocab_major,
                              seed=vocab % 97)
    lse, _ = fc.ce_fwd(h, w, y, vocab_major)
    dh = fc.ce_bwd(h, w, y, lse, dce, vocab_major)[0]
    dh_p = fc.ce_bwd_plain(h, w, y, lse, dce, vocab_major)[0]
    wv = (w if vocab_major else w.t()).double()
    s = torch.where(y >= 0, dce.double(), torch.zeros_like(dce.double()))
    ref = torch.empty((n, hd), dtype=torch.float64, device=dev)
    for r0 in range(0, n, 256):
        d = torch.exp(h[r0:r0 + 256].double() @ wv.t()
                      - lse[r0:r0 + 256, None].double())
        yy = y[r0:r0 + 256]
        hit = (yy >= 0) & (yy < vocab)
        d[torch.arange(d.shape[0], device=dev)[hit], yy[hit]] -= 1
        d *= s[r0:r0 + 256, None]
        ref[r0:r0 + 256] = d.to(dtype).double() @ wv
    err, err_p = (dh.double() - ref).abs(), (dh_p.double() - ref).abs()
    assert float(err.mean()) <= 1.05 * float(err_p.mean()), (
        float(err.mean()), float(err_p.mean()))
    assert float(err.max()) <= 1.1 * float(err_p.max()), (
        float(err.max()), float(err_p.max()))


def test_fused_ce_backward_refuses_a_chunk_past_its_limit(dev):
    """The C entry takes vocabulary chunks of up to ``_CHUNK_V`` columns
    (the source's kChunkV) and refuses a wider one before any launch."""
    from paddle_tpu_torch.kernels import fused_ce as fc
    n, hd, vocab = 4, 8, 3 * fc._CHUNK_V
    h, w, y, dce = _ce_inputs(dev, n, hd, vocab, torch.bfloat16, True)
    lse, _ = fc.ce_fwd(h, w, y)
    y32, s = y.to(torch.int32), torch.where(y >= 0, dce, 0 * dce)
    dh, dw = torch.empty_like(h), torch.empty_like(w)
    acc = torch.empty((n, hd), dtype=torch.float32, device=dev)
    for vc, ok in ((fc._CHUNK_V, True),
                   (fc._CHUNK_V + fc._CHUNK_STEP, False)):
        d = torch.empty((n, vc), dtype=h.dtype, device=dev)
        err = fc._library().paddle_ce_bwd(
            h.data_ptr(), w.data_ptr(), y32.data_ptr(), lse.data_ptr(),
            s.data_ptr(), dh.data_ptr(), dw.data_ptr(), d.data_ptr(),
            acc.data_ptr(), n, vocab, hd, vc, 1, fc._stream(h))
        torch.cuda.synchronize()
        assert (err == 0) == ok, (vc, err)


# -------------------------------- fused 3x3 forward on the GEMM route

@pytest.mark.parametrize("n,h,w,c,o,route", [
    (128, 28, 28, 128, 128, "gemm"),   # ResNet-50 layer2-4 at b128
    (128, 14, 14, 256, 256, "gemm"),
    (128, 7, 7, 512, 512, "gemm"),
    (4, 28, 28, 128, 136, "gemm"),     # the route's edges: the largest
    (4, 29, 28, 128, 128, "window"),   # image, one row past it,
    (4, 7, 7, 128, 128, "gemm"),       # the fewest channels,
    (4, 7, 7, 120, 128, "window"),     # and fewer
    (3, 7, 5, 136, 128, "gemm"),       # pixels off 128, channels off 64
])
def test_conv3x3_forward_routes(dev, n, h, w, c, o, route):
    """Row 17 on the route the wrapper chooses for (H, W, C, O), and on
    the other one, against the plain version by rows 13-16's rules in
    bf16, with a shift that makes relu(shift) > 0 (the border must read
    0); bits repeated."""
    from paddle_tpu_torch.kernels import fused_resnet as fr
    assert fr._conv3x3_route(h, w, c, o) == route
    gen = torch.Generator(device=dev).manual_seed(n + h + c + o)
    x, scale, shift, w9, _, _, _ = _conv3x3_inputs(
        gen, n, h, w, c, o, torch.bfloat16, dev, 0.3)
    ref = fr.conv3x3_bn_stats_fwd_plain(x, scale, shift, w9)
    for r in ("gemm", "window"):
        out = fr._launch_fwd3(x, scale, shift, w9, r)
        again = fr._launch_fwd3(x, scale, shift, w9, r)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, again))
        _close_scaled(out[0], ref[0], _ULP[torch.bfloat16])
        _close_stats(out[1], out[2], ref[1], ref[2])


def test_conv3x3_forward_gemm_route_fp32(dev):
    """The forward GEMM route in fp32 (its indexing at one fp32 ulp) at a
    shape off its tiles, the border under a positive shift."""
    from paddle_tpu_torch.kernels import fused_resnet as fr
    gen = torch.Generator(device=dev).manual_seed(77)
    x, scale, shift, w9, _, _, _ = _conv3x3_inputs(
        gen, 3, 7, 5, 136, 72, torch.float32, dev, 0.3)
    out = fr._launch_fwd3(x, scale, shift, w9, "gemm")
    ref = fr.conv3x3_bn_stats_fwd_plain(x, scale, shift, w9)
    _close_scaled(out[0], ref[0], _ULP[torch.float32])
    _close_stats(out[1], out[2], ref[1], ref[2])


# ----------------------------- head dims the kernels are not built for

def test_sdpa_and_cached_attention_at_head_dim_80(dev):
    """F.scaled_dot_product_attention and every window of
    cached_attention at head_dim 80 take the JAX package's XLA routes on
    the card: the CPU's results, no kernel launch, no plain-version
    call, no exception."""
    from paddle_tpu_torch.generation.attention import cached_attention
    from paddle_tpu_torch.generation.kv_cache import KVCache
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.functional.attention import sdpa_xla
    gen = torch.Generator(device=dev).manual_seed(80)
    d = 80
    q, k, v = (_randn(gen, (2, 24, 4, d), torch.float32, dev)
               for _ in range(3))
    fa.reset_counts()
    sdpa_xla.calls = 0
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                         training=False)
    ref = F.scaled_dot_product_attention(q.cpu(), k.cpu(), v.cpu(),
                                         is_causal=True, training=False)
    torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=1e-5)
    for window in (3, 12):
        caches = []
        for device in (dev, torch.device("cpu")):
            cache = KVCache.create(1, 2, 64, 4, d, device=device)
            cache.k.copy_(_randn(gen, cache.k.shape, torch.float32, dev))
            cache.v.copy_(_randn(gen, cache.v.shape, torch.float32, dev))
            cache.kv_len.copy_(torch.tensor([5, 30]))
            caches.append(cache)
        caches[1].k.copy_(caches[0].k.cpu())
        caches[1].v.copy_(caches[0].v.cpu())
        qs = q[:, :window]
        got, _ = cached_attention(qs, k[:, :window], v[:, :window],
                                  caches[0], 0, decode=True, causal=True)
        want, _ = cached_attention(qs.cpu(), k[:, :window].cpu(),
                                   v[:, :window].cpu(), caches[1], 0,
                                   decode=True, causal=True)
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    torch.cuda.synchronize()
    assert sdpa_xla.calls == 2 and fa.decode_xla.calls == 4
    assert (fa.flash_attention.launches, fa.flash_attention_decode.launches,
            fa.flash_attention_chunk.launches) == (0, 0, 0)
    assert (fa.flash_attention_plain.calls,
            fa.flash_attention_decode_plain.calls,
            fa.flash_attention_chunk_plain.calls) == (0, 0, 0)


# ------------------------------------------- int8 compute, weight-only


@pytest.mark.parametrize("m", [1, 8, 16, 17, 40, 300])
@pytest.mark.parametrize("k,n", [(64, 24), (60, 20), (768, 3072)])
def test_int8_matmul_accumulators_match_the_cpu(dev, m, k, n):
    """``int8_matmul`` on the card (cuBLASLt's int8 GEMM through
    ``torch._int_mm``, operands zero-padded to the shapes it takes)
    gives the CPU's exact int32 sums, also at row, inner and column
    counts the card refuses unpadded."""
    from paddle_tpu_torch.quantization.int8_compute import int8_matmul
    gen = torch.Generator().manual_seed(m * 1000 + k)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    want = torch._int_mm(a, b)
    got = int8_matmul(a.to(dev), b.to(dev))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert torch.equal(got.cpu(), want)


def test_int8_compute_layers_on_card_match_the_cpu(dev):
    """Int8ComputeLinear and Int8ComputeConv2D (im2col into int8_matmul)
    on the card: int32 accumulators equal to the CPU's."""
    from paddle_tpu_torch.nn import Conv2D, Linear
    from paddle_tpu_torch.quantization import (Int8ComputeConv2D,
                                               Int8ComputeLinear)
    g = torch.Generator().manual_seed(3)
    lin = Linear(96, 40, device="cpu", generator=g)
    conv = Conv2D(4, 6, 3, padding=[1, 2, 0, 1], stride=2, device="cpu",
                  generator=g)
    x_lin = torch.randn((3, 5, 96), generator=g)
    x_conv = torch.randn((2, 4, 9, 7), generator=g)
    for layer, build, x in ((lin, Int8ComputeLinear.from_linear, x_lin),
                            (conv, Int8ComputeConv2D.from_conv, x_conv)):
        cpu = build(layer)
        card = build(layer).to(dev)
        _, _, want = cpu.accumulate(x)
        _, _, got = card.accumulate(x.to(dev))
        assert torch.equal(got.cpu(), want)
        torch.testing.assert_close(card(x.to(dev)).cpu(), cpu(x),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("opts", [dict(weight_bits=8), dict(weight_bits=4),
                                  dict(weight_bits=4, paged=True,
                                       kv_page_size=8,
                                       kv_cache_dtype="int8")],
                         ids=["w8", "w4", "w4_paged_int8kv"])
def test_weight_only_engine_matches_batch1_generate(dev, opts):
    """test-tiny served with int8 / int4 weights on the card: each
    stream equals batch-1 ``generate`` on the engine's own quantized
    module, through the decode kernels and no plain version."""
    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.inference import Config
    from paddle_tpu_torch.models.gpt import gpt
    from paddle_tpu_torch.serving import RequestParams, ServingEngine
    model = gpt("test-tiny", device=dev).eval()
    with torch.no_grad():                # streams that vary
        for name, p in model.named_parameters():
            if p.dim() == 2 and "wte" not in name:
                p.mul_(2.0)
    cfg = (Config().from_layer(model).enable_use_gpu("int8")
           .enable_generation(max_new_tokens=8, prefill_buckets=(16, 32),
                              max_batch=2)
           .enable_serving(**opts))
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 512, n) for n in (5, 12, 20, 7, 3, 31)]
    eng = ServingEngine(cfg, poll_every=2)
    fa.reset_counts()
    hs = [eng.submit(p, RequestParams(max_new_tokens=8)) for p in prompts]
    while eng.busy:
        eng.step()
    kv = opts.get("kv_cache_dtype")
    for p, h in zip(prompts, hs):
        bucket = next(b for b in eng.buckets if b >= p.size)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :p.size] = p
        ref = generate(eng.network, ids, 8, prompt_len=[p.size],
                       cache_max_len=eng.max_len, kv_cache_dtype=kv)
        np.testing.assert_array_equal(h.result(timeout=60),
                                      ref.cpu().numpy()[0])
    assert fa.flash_attention_decode_plain.calls == 0
    assert fa.flash_attention_decode_paged_plain.calls == 0
    assert all(p.dtype == torch.bfloat16 for p in eng.network.parameters())
    eng.shutdown()


# ---------------------------------------------- training: A4


def test_flash_fp16_training_shape_matches_plain(dev):
    """Rows 1-4 in fp16 at gpt2-small's heads, b2 s512 (AMP O2 runs
    them in fp16): forward and backward within one fp16 ulp of the plain
    versions."""
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v, do = _bwd_inputs(gen, 2, 512, 512, 12, 12, 64, torch.float16,
                              dev)
    out = fa.flash_attention(q, k, v, causal=True)
    _close(out, fa.flash_attention_plain(q, k, v, causal=True))
    _check_bwd(q, k, v, do, True)


def _tiny_train(dev, steps, **step_kw):
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.models.gpt import gpt
    m = gpt("test-tiny", device=dev, dtype=torch.bfloat16,
            generator=torch.Generator(device=dev).manual_seed(0))
    opt = optimizer.AdamW(1e-3, parameters=m.parameters(),
                          multi_precision=True)
    step = jit.TrainStep(m, opt, lambda o, y: m.loss(o, y), **step_kw)
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, 512, (3, 50)),
                          device=dev)
    losses, pinned = [], []
    for _ in range(steps):
        losses.append(step(ids, ids).item())
        pinned.append(all(t.device.type == "cpu" and t.is_pinned()
                          for st in opt._state.values() for t in st.values()))
    return m, opt, losses, pinned


def test_offload_state_is_pinned_and_bitwise_to_resident(dev):
    """``offload_opt_state`` keeps the moments and fp32 masters in
    pinned host memory between steps; the losses, parameters and state
    equal the resident run's bit for bit."""
    m0, o0, l0, _ = _tiny_train(dev, 3)
    m1, o1, l1, pinned = _tiny_train(dev, 3, offload_opt_state=True)
    assert o1.offload_state and all(pinned)
    assert l1 == l0
    for a, b in zip(m0.parameters(), m1.parameters()):
        assert torch.equal(a, b)
    s0, s1 = o0.state_dict(), o1.state_dict()
    for key in s0:
        if key.startswith("param_"):
            assert set(s0[key]) == {"moment1", "moment2", "master"}
            for name, t in s0[key].items():
                assert torch.equal(s1[key][name], t.cpu())


@pytest.mark.parametrize("how", ["selective", "full", "trainstep"])
def test_recompute_with_kernels_is_bitwise(dev, how):
    """Recompute on the card: the flash forward runs twice a block, the
    backward once, and the loss and every gradient equal the run
    without recompute bit for bit (the kernels repeat their bits)."""
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.models.gpt import gpt
    ids = torch.as_tensor(np.random.RandomState(1).randint(0, 512, (2, 64)),
                          device=dev)
    runs = []
    for on in (False, True):
        m = gpt("test-tiny", device=dev, dtype=torch.bfloat16,
                generator=torch.Generator(device=dev).manual_seed(0),
                use_recompute=on and how != "trainstep",
                recompute_granularity=how)
        fa.reset_counts()
        if how == "trainstep":
            opt = optimizer.SGD(0.0, parameters=m.parameters())
            step = jit.TrainStep(m, opt, lambda o, y, m=m: m.loss(o, y),
                                 recompute="full" if on else None)
            grads = {}
            orig = opt.apply_gradients

            def keep(params, gs, **kw):
                grads.update({i: g.clone() for i, g in enumerate(gs)})
                return orig(params, gs, **kw)
            opt.apply_gradients = keep
            loss = step(ids, ids).item()
        else:
            loss = m.loss(m(ids), ids)
            loss.backward()
            loss = loss.item()
            grads = {n: p.grad for n, p in m.named_parameters()}
        torch.cuda.synchronize()
        runs.append((loss, grads, fa.flash_attention.launches,
                     fa.flash_attention_bwd.launches,
                     fa.flash_attention_plain.calls))
    (l0, g0, f0, b0, p0), (l1, g1, f1, b1, p1) = runs
    assert (f0, b0, p0) == (2, 2, 0) and (f1, b1, p1) == (4, 2, 0)
    assert l1 == l0
    assert g1.keys() == g0.keys()
    for n in g0:
        assert torch.equal(g1[n], g0[n]), n


def test_recomputed_bn_blocks_leave_running_stats(dev):
    """A small fused ResNet in bf16 with ``recompute_stages=(1, 2)``: in
    ``TrainStep`` the recomputed blocks' BN forwards move no running
    statistic, the loss equals the run without recompute, and the
    stages' forward kernels launch once more."""
    from paddle_tpu_torch import jit, nn, optimizer
    from paddle_tpu_torch.kernels import fused_resnet as fr
    from paddle_tpu_torch.models import resnet as rn
    img = torch.as_tensor(np.random.RandomState(2).randn(4, 3, 64, 64)
                          .astype(np.float32), device=dev).bfloat16()
    lbl = torch.as_tensor([1, 2, 3, 4], device=dev)
    runs = []
    for stages in ((), (1, 2)):
        m = rn.ResNet(rn.BottleneckBlock, [2, 1, 1, 2], num_classes=10,
                      data_format="NHWC", fused_bn=True,
                      stem_space_to_depth=True, recompute_stages=stages,
                      device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(0))
        opt = optimizer.Momentum(0.1, 0.9, parameters=m.parameters(),
                                 multi_precision=True)
        ce = nn.CrossEntropyLoss()
        step = jit.TrainStep(m, opt, lambda o, y: ce(o.float(), y))
        before = {k: v.clone() for k, v in m.state_dict().items()
                  if k.endswith(("_mean", "_variance"))}
        fr.reset_counts()
        losses = [step(img, lbl).item() for _ in range(2)]
        torch.cuda.synchronize()
        after = m.state_dict()
        assert all(torch.equal(after[k], v) for k, v in before.items())
        runs.append((losses, [f.launches for f in fr.KERNEL_WRAPPERS],
                     sum(f.calls for f in fr.PLAIN_VERSIONS)))
    (l0, k0, p0), (l1, k1, p1) = runs
    assert l1 == l0 and p0 == p1 == 0
    assert [b - a for a, b in zip(k0, k1)] == [10, 6, 0, 0, 4, 0]


# ------------------------------------------- row_gemm (ROADMAP C12)

# gpt2-small's five products; ragged to the tile and box (multiples of 8:
# the warpgroup route, TMA's zero fill); ragged to 8 (the CUDA-core route)
_ROW_SHAPES = [(768, 2304), (768, 768), (768, 3072), (3072, 768),
               (768, 50257), (200, 328), (64, 37), (60, 20)]
#: row counts held against the 4096-row run: a token, a verify window, a
#: decode step, an 8-slot window, both sides of the 64-row tile's edges,
#: a prefill bucket
_ROW_COUNTS = (1, 5, 8, 40, 63, 64, 65, 127, 128, 129, 512)
#: single rows held against it: inside, at and past the tile edges
_ROW_ALONE = (0, 3, 63, 64, 65, 127, 128, 129, 2049, 4095)


def _row_operands(gen, k, n, dtype, dev, layout, bias):
    if layout == "head":      # the tied head: wte [N, K] seen as [K, N]
        w = (_randn(gen, (n, k), dtype, dev) * 0.02).t()
    else:
        w = _randn(gen, (k, n), dtype, dev) * 0.02
    return w, (_randn(gen, (n,), dtype, dev) if bias else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("k,n", _ROW_SHAPES)
@pytest.mark.parametrize("layout", ["kn", "head"])
def test_row_linear_matches_plain(dev, dtype, k, n, layout):
    from paddle_tpu_torch.kernels import row_linear as rl
    gen = torch.Generator(device=dev).manual_seed(k + n)
    x = _randn(gen, (40, k), dtype, dev)
    w, b = _row_operands(gen, k, n, dtype, dev, layout, layout == "kn")
    rl.reset_counts()
    out = rl.row_linear(x, w, b)
    assert rl.row_linear.launches == 1 and rl.row_linear_plain.calls == 0
    _close(out, rl.row_linear_plain(x, w, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("k,n", _ROW_SHAPES)
@pytest.mark.parametrize("layout,bias", [("kn", True), ("kn", False),
                                         ("head", False), ("head", True)])
def test_row_linear_rows_do_not_depend_on_the_row_count(dev, dtype, k, n,
                                                         layout, bias):
    """ROADMAP C12: each row of an M-row call has the bits of the same
    row in a 4096-row call, for every M of ``_ROW_COUNTS``, alone at the
    tile edges, and whatever the other rows hold; a call repeats bit for
    bit."""
    from paddle_tpu_torch.kernels import row_linear as rl
    gen = torch.Generator(device=dev).manual_seed(7)
    x = _randn(gen, (4096, k), dtype, dev)
    w, b = _row_operands(gen, k, n, dtype, dev, layout, bias)
    full = rl.row_linear(x, w, b)
    assert torch.equal(rl.row_linear(x, w, b), full)
    for m in _ROW_COUNTS:
        assert torch.equal(rl.row_linear(x[:m], w, b), full[:m]), m
    for r in _ROW_ALONE:
        assert torch.equal(rl.row_linear(x[r:r + 1], w, b), full[r:r + 1])
    other = x.clone()
    other[1::2] = _randn(gen, (2048, k), dtype, dev) * 100
    assert torch.equal(rl.row_linear(other, w, b)[::2], full[::2])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_row_linear_unaligned_row_view_is_copied(dev, dtype):
    """A view of x at an address TMA cannot take is copied into fresh
    memory and takes the layer's one route: its rows get the bits of the
    same rows at an aligned address."""
    from paddle_tpu_torch.kernels import row_linear as rl
    gen = torch.Generator(device=dev).manual_seed(9)
    k, n = 768, 2304
    flat = _randn(gen, (9 * k + 1,), dtype, dev)
    view = flat[1:].view(9, k)
    assert view.data_ptr() % 16
    w, b = _row_operands(gen, k, n, dtype, dev, "kn", True)
    rl.reset_counts()
    got = rl.row_linear(view, w, b)
    assert rl.row_linear.launches == 1
    assert torch.equal(got, rl.row_linear(view.clone(), w, b))
    _close(got, rl.row_linear_plain(view, w, b))


@pytest.mark.parametrize("m", [8, 512])
@pytest.mark.parametrize("k,n,layout", [(768, 2304, "kn"), (768, 768, "kn"),
                                        (768, 3072, "kn"), (3072, 768, "kn"),
                                        (768, 50257, "head")])
def test_row_linear_is_one_kernel_a_product(dev, m, k, n, layout):
    """One launch a product: the splits fold inside a cluster, so no
    second kernel (and no device-memory partial) runs."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.kernels import row_linear as rl
    gen = torch.Generator(device=dev).manual_seed(11)
    x = _randn(gen, (m, k), torch.bfloat16, dev)
    w, b = _row_operands(gen, k, n, torch.bfloat16, dev, layout,
                         layout == "kn")
    p = rl.plan(k, n, torch.bfloat16, layout == "head", True)
    assert p.route == "wgmma" and 1 <= p.splits <= rl.MAX_SPLITS
    rl.row_linear(x, w, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):   # CUPTI's start-up
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            rl.row_linear(x, w, b)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    assert len(kernels) == 3 and all("row_gemm_wgmma" in k
                                     for k in kernels), kernels


def test_cached_gpt_forward_launches_row_gemm(dev):
    from paddle_tpu_torch.kernels import row_linear as rl
    from paddle_tpu_torch.models.gpt import gpt
    m = gpt("test-tiny", device=dev, dtype=torch.bfloat16,
            generator=torch.Generator(device=dev).manual_seed(0)).eval()
    ids = torch.randint(0, 512, (3, 16), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    rl.reset_counts()
    with torch.no_grad():
        logits, cache = m(ids, use_cache=True, cache_max_len=64)
        m(ids[:, :1], cache=cache)
        m(ids)                        # uncached: cuBLAS
    assert rl.row_linear.launches == 2 * (2 * 4 + 1)
    assert rl.row_linear_plain.calls == 0


def test_ernie_training_step_matches_plain_kernels(dev):
    """Rows 1-4 non-causal inside ERNIE's training step at test-tiny:
    loss and gradients against the same step on the plain kernels."""
    from unittest import mock
    from paddle_tpu_torch.models.ernie import ernie
    m = ernie("test-tiny", device=dev, fused_mlm_loss=True,
              generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(2)
    ids = torch.randint(0, 512, (2, 64), device=dev, generator=gen)
    mlm = torch.where(torch.rand((2, 64), device=dev, generator=gen) < 0.2,
                      ids, torch.full_like(ids, -100))
    y = (mlm, torch.tensor([0, 1], device=dev))

    def run():
        m.zero_grad(set_to_none=True)
        loss = m.loss(m(ids), y)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in m.named_parameters()}
    fa.reset_counts()
    loss, grads = run()
    assert (fa.flash_attention.launches,
            fa.flash_attention_bwd.launches) == (2, 2)
    with mock.patch.object(fa, "_forward", fa.flash_attention_plain), \
            mock.patch.object(fa, "flash_attention_bwd",
                              fa.flash_attention_bwd_plain):
        ref_loss, ref = run()
    assert abs(loss - ref_loss) < 1e-4
    for n, g in grads.items():
        torch.testing.assert_close(g, ref[n], atol=1e-4, rtol=1e-3,
                                   msg=n)
