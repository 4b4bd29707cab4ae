"""Card tests: each hand-written CUDA kernel of paddle_tpu_torch against its
plain PyTorch version on the same CUDA inputs.

Marked ``cuda``; without a card every test skips (decided inside the
``cuda`` fixture, so every worker collects the same tests).  The file
imports neither jax nor paddle_tpu, so it runs on a machine with only
PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

Tolerances: f32 kernels against f32 plain versions that sum in another
order; |kernel - plain| <= 1e-4 + 1e-4 * |plain|.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import int8_matmul, paged_attention as pa
from paddle_tpu_torch.quantization import quantize_weight_int8

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [
    (8, 1024, 3072), (8, 1024, 1024), (8, 1024, 4096), (8, 4096, 1024),
    (1, 64, 128), (5, 32, 128), (300, 32, 128), (16, 96, 144),
    (512, 1024, 4096)])
def test_int8_matmul_kernel_matches_plain(cuda, m, k, n):
    rng = np.random.RandomState(m * 7 + n)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(cuda)
    w = torch.from_numpy((0.02 * rng.randn(k, n)).astype(np.float32))
    wi, s = quantize_weight_int8(w.to(cuda))
    before = int8_matmul.dequant_matmul.launches
    got = int8_matmul.dequant_matmul(x, wi, s)
    torch.cuda.synchronize()
    assert int8_matmul.dequant_matmul.launches == before + 1
    want = int8_matmul._plain(x, wi, s)
    torch.testing.assert_close(got, want, **TOL)


def test_int8_matmul_per_tensor_scale_and_batch_dims(cuda):
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 3, 64).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.randn(64, 256).astype(np.float32)).to(cuda)
    wi, s = quantize_weight_int8(w, per_channel=False)
    got = int8_matmul.dequant_matmul(x, wi, s)
    want = int8_matmul._plain(x.reshape(-1, 64), wi,
                              s.reshape(1, 1).expand(1, 256))
    torch.testing.assert_close(got.reshape(-1, 256), want, **TOL)


def test_int8_matmul_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(2, 32, device=cuda)
    wi = torch.zeros(32, 24, dtype=torch.int8, device=cuda)  # N % 16 != 0
    with pytest.raises(ValueError):
        int8_matmul.dequant_matmul(x, wi, torch.ones(1, 24, device=cuda))
    with pytest.raises(TypeError):
        int8_matmul.dequant_matmul(
            x.to(torch.bfloat16),
            torch.zeros(32, 32, dtype=torch.int8, device=cuda),
            torch.ones(1, 32, device=cuda))


def _paged_case(rng, s, nb_pool, bs, h, d, nb, pos):
    kpool = torch.from_numpy(rng.randn(nb_pool, bs, h, d).astype(np.float32))
    vpool = torch.from_numpy(rng.randn(nb_pool, bs, h, d).astype(np.float32))
    q = torch.from_numpy(rng.randn(s, h, d).astype(np.float32))
    tables = np.full((s, nb), nb_pool, np.int32)  # sentinel tail entries
    perm = rng.permutation(nb_pool)
    for i, p in enumerate(pos):
        live = -(-(p + 1) // bs)
        tables[i, :live] = perm[:live]
        perm = np.roll(perm, live)
    return (q, kpool, vpool, torch.from_numpy(tables),
            torch.tensor(pos, dtype=torch.int32))


@pytest.mark.parametrize("s,bs,h,d,pos", [
    (8, 16, 16, 64, [17, 100, 511, 512, 700, 1000, 0, 15]),
    (3, 4, 2, 32, [0, 5, 9]),
    (2, 8, 4, 128, [63, 30]),
    (1, 16, 1, 256, [200]),
])
def test_paged_attention_kernel_matches_plain(cuda, s, bs, h, d, pos):
    rng = np.random.RandomState(len(pos) + d)
    nb = -(-(max(pos) + 1) // bs) + 2
    args = _paged_case(rng, s, nb * s, bs, h, d, nb, pos)
    args = [a.to(cuda) for a in args]
    before = pa.paged_attention.launches
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    want = pa._plain(*args)
    torch.testing.assert_close(got, want, **TOL)


def test_paged_attention_clamps_out_of_range_ids(cuda):
    rng = np.random.RandomState(0)
    q, kpool, vpool, tables, pos = _paged_case(rng, 2, 6, 4, 2, 32, 4,
                                                [9, 3])
    tables[0, 1] = 999   # live entry out of range: clamps to block 5
    tables[1, 0] = -3    # negative: clamps to block 0
    args = [a.to(cuda) for a in (q, kpool, vpool, tables, pos)]
    torch.testing.assert_close(pa.paged_attention(*args), pa._plain(*args),
                               **TOL)


def test_paged_attention_rejects_bad_inputs(cuda):
    q = torch.zeros(2, 2, 32, device=cuda)
    pool = torch.zeros(4, 4, 2, 32, device=cuda)
    tables = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        pa.paged_attention(q, pool, pool, tables.long(), pos)
    with pytest.raises(ValueError):
        pa.paged_attention(q, pool, pool, tables, pos.cpu())
    with pytest.raises(ValueError):
        pa.paged_attention(torch.zeros(2, 2, 24, device=cuda),
                           torch.zeros(4, 4, 2, 24, device=cuda),
                           torch.zeros(4, 4, 2, 24, device=cuda), tables, pos)


def test_int8_matmul_offset_views(cuda):
    """A contiguous weight view that starts 16 bytes into its storage is
    taken; one that starts 1 byte in is refused (16-byte weight loads)."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(4, 32).astype(np.float32)).to(cuda)
    wi, s = quantize_weight_int8(
        torch.from_numpy(rng.randn(32, 64).astype(np.float32)).to(cuda))
    flat = torch.zeros(16 + wi.numel(), dtype=torch.int8, device=cuda)
    aligned = flat[16:].view(32, 64)
    aligned.copy_(wi)
    torch.testing.assert_close(int8_matmul.dequant_matmul(x, aligned, s),
                               int8_matmul._plain(x, wi, s), **TOL)
    misaligned = flat[1:1 + wi.numel()].view(32, 64)
    with pytest.raises(ValueError, match="aligned"):
        int8_matmul.dequant_matmul(x, misaligned, s)


def test_paged_attention_offset_views(cuda):
    """Pools that start 16 bytes into their storage are taken; pools that
    start 4 bytes in are refused (16-byte K/V loads)."""
    rng = np.random.RandomState(6)
    q, kpool, vpool, tables, pos = [
        a.to(cuda) for a in _paged_case(rng, 2, 6, 4, 2, 32, 3, [9, 3])]
    n = kpool.numel()

    def at(src, offset):
        flat = torch.zeros(offset + n, device=cuda)
        view = flat[offset:].view(kpool.shape)
        view.copy_(src)
        return view
    got = pa.paged_attention(q, at(kpool, 4), at(vpool, 4), tables, pos)
    torch.testing.assert_close(got, pa._plain(q, kpool, vpool, tables, pos),
                               **TOL)
    with pytest.raises(ValueError, match="aligned"):
        pa.paged_attention(q, at(kpool, 1), vpool, tables, pos)


# ---------------------------------------------------------------------------
# K1 / K2: flash attention forward and backward
# ---------------------------------------------------------------------------
# f32: the kernels sum in another order than the plain version's einsums;
# outputs and the logsumexp within 1e-4 + 1e-4 * |plain|, gradients (sums
# over up to 1024 rows) within 2e-4 + 1e-3 * |plain|.  bf16: both round the
# same f32 values to bf16, so they may differ by one bf16 unit (2**-8
# relative): 1e-2 + 1e-2 * |plain|.
FLASH_TOL = {torch.float32: (dict(rtol=1e-4, atol=1e-4),
                             dict(rtol=1e-3, atol=2e-4)),
             torch.bfloat16: (dict(rtol=1e-2, atol=1e-2),
                              dict(rtol=1e-2, atol=1e-2))}


def _flash_case(cuda, b, sq, sk, h, d, dtype, bias=False, seg=False,
                seed=0):
    rng = np.random.RandomState(seed + sq + d)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            cuda).to(dtype)
    q, k, v, do = t(b, sq, h, d), t(b, sk, h, d), t(b, sk, h, d), \
        t(b, sq, h, d)
    bi = (torch.from_numpy(rng.randn(b, sk).astype(np.float32)).to(cuda)
          if bias else None)
    qs = ks = None
    if seg:   # two packed segments per row, both sides starting at id 0
        qs = torch.zeros(b, sq, dtype=torch.int32, device=cuda)
        ks = torch.zeros(b, sk, dtype=torch.int32, device=cuda)
        qs[:, sq // 2:] = 1
        ks[:, sk // 3:] = 1
    return q, k, v, do, bi, qs, ks


@pytest.mark.parametrize("b,sq,sk,h,d,dtype,causal,bias,seg,p", [
    (4, 1024, 1024, 16, 64, torch.bfloat16, True, False, False, 0.1),
    (4, 1024, 1024, 16, 64, torch.float32, True, False, False, 0.1),
    (2, 256, 256, 2, 64, torch.float32, False, False, False, 0.0),
    (1, 384, 384, 2, 64, torch.float32, True, False, False, 0.0),
    (2, 128, 256, 2, 64, torch.float32, True, False, False, 0.0),
    (2, 256, 256, 2, 128, torch.float32, False, True, False, 0.0),
    (2, 256, 256, 2, 64, torch.float32, False, False, True, 0.0),
    (2, 256, 384, 3, 256, torch.float32, True, True, False, 0.2),
    (2, 256, 256, 2, 128, torch.bfloat16, True, True, False, 0.1),
    (1, 256, 256, 2, 256, torch.bfloat16, False, False, True, 0.1),
])
def test_flash_kernels_match_plain(cuda, b, sq, sk, h, d, dtype, causal,
                                   bias, seg, p):
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do, bi, qs, ks = _flash_case(cuda, b, sq, sk, h, d, dtype,
                                          bias, seg)
    seed = torch.tensor([-123457], dtype=torch.int32, device=cuda)
    args = (q, k, v, bi, qs, ks, seed, causal, p)
    f0, b0 = fa.flash_fwd.launches, fa.flash_bwd.launches
    o, lse = fa.flash_fwd(*args)
    grads = fa.flash_bwd(q, k, v, bi, qs, ks, seed, o, lse, do, causal, p)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == (f0 + 1, b0 + 1)
    po, plse = fa._plain_fwd(*args)
    pgrads = fa._plain_bwd(q, k, v, bi, qs, ks, seed, o, lse, do, causal, p)
    tol_o, tol_g = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), po.float(), **tol_o)
    torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-4)
    for g, pg in zip(grads, pgrads):
        if pg is None:
            assert g is None
            continue
        assert g.dtype == pg.dtype and g.shape == pg.shape
        torch.testing.assert_close(g.float(), pg.float(), **tol_g)


def test_flash_autograd_on_fused_qkv_views(cuda):
    """q/k/v as strided slices of one fused-QKV tensor, as GPT passes
    them: the kernels read them in place, and the gradient reaching the
    fused tensor equals the plain path's."""
    from paddle_tpu_torch.ops import flash_attention as fa
    rng = np.random.RandomState(7)
    qkv = torch.from_numpy(rng.randn(2, 256, 3, 4, 64).astype(np.float32))
    do = torch.from_numpy(rng.randn(2, 256, 4, 64).astype(np.float32))
    seed = torch.tensor([99], dtype=torch.int32)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        x = qkv.to(dev).requires_grad_()
        o = fa.flash_attention_bshd(x[:, :, 0], x[:, :, 1], x[:, :, 2],
                                    causal=True, dropout_p=0.1,
                                    dropout_seed=seed.to(dev))
        o.backward(do.to(dev))
        outs.append((o.detach().cpu(), x.grad.cpu()))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-3, atol=2e-4)


def test_flash_rejects_what_the_kernels_do_not_take(cuda):
    from paddle_tpu_torch.ops import flash_attention as fa
    q = torch.zeros(1, 128, 2, 64, device=cuda)
    seed = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):      # fp16 is not a kernel type
        fa.flash_fwd(q.half(), q.half(), q.half(), None, None, None, seed,
                     False, 0.0)
    with pytest.raises(ValueError):     # head_dim 32
        z = torch.zeros(1, 128, 2, 32, device=cuda)
        fa.flash_fwd(z, z, z, None, None, None, seed, False, 0.0)
    with pytest.raises(ValueError):     # a CPU k beside a CUDA q
        fa.flash_fwd(q, q.cpu(), q, None, None, None, seed, False, 0.0)
    with pytest.raises(ValueError):     # bias of the wrong shape
        fa.flash_fwd(q, q, q, torch.zeros(1, 64, device=cuda), None, None,
                     seed, False, 0.0)
    with pytest.raises(ValueError):     # non-unit stride along head_dim
        wide = torch.zeros(1, 128, 2, 128, device=cuda)[..., ::2]
        fa.flash_fwd(wide, wide, wide, None, None, None, seed, False, 0.0)
    # the gate refuses what the reference refuses: None, no launch
    n = fa.flash_fwd.launches
    assert fa.flash_attention_bshd(q[:, :100], q[:, :100], q[:, :100]) is None
    assert fa.flash_attention_bshd(q, q, q, dropout_p=0.1) is None
    assert fa.flash_fwd.launches == n


def test_flash_backward_rejects_mismatched_saved_tensors(cuda):
    from paddle_tpu_torch.ops import flash_attention as fa
    q = torch.zeros(1, 128, 2, 64, device=cuda)
    seed = torch.zeros(1, dtype=torch.int32, device=cuda)
    o, lse = fa.flash_fwd(q, q, q, None, None, None, seed, True, 0.0)
    with pytest.raises(ValueError):     # do of another shape
        fa.flash_bwd(q, q, q, None, None, None, seed, o, lse, q[:, :64],
                     True, 0.0)
    with pytest.raises(ValueError):     # lse of another shape
        fa.flash_bwd(q, q, q, None, None, None, seed, o, lse[:, :1], q,
                     True, 0.0)
