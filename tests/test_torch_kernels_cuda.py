"""Card tests: each hand-written CUDA kernel of paddle_tpu_torch against its
plain PyTorch version on the same CUDA inputs.

Marked ``cuda``; without a card every test skips (decided inside the
``cuda`` fixture, so every worker collects the same tests).  The file
imports neither jax nor paddle_tpu, so it runs on a machine with only
PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

Tolerances: f32 kernels against f32 plain versions that sum in another
order; |kernel - plain| <= 1e-4 + 1e-4 * |plain|.  K3 and K4 on bf16
operands compute in f32 like their plain versions and round once to bf16,
so the two may round f32 values that differ in their last bits to
neighbouring bf16 values: 1e-3 + 8e-3 * |plain| (8e-3 > 2**-7, one bf16
unit at its largest relative size).  On float16 operands the same
argument gives 1e-4 + 2e-3 * |plain| (2e-3 > 2**-10, one float16 unit at
its largest relative size).  The
fused BatchNorm kernels (K5-K9) as stated beside their tests.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import fused_bn_act as fbn
from paddle_tpu_torch.ops import int8_matmul, paged_attention as pa
from paddle_tpu_torch.quantization import quantize_weight_int8

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=8e-3, atol=1e-3)
F16_TOL = dict(rtol=2e-3, atol=1e-4)


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


@pytest.mark.parametrize("k", [1024, 4096])
@pytest.mark.parametrize("n", [16, 1024, 3072])
@pytest.mark.parametrize("m", [1, 8, 16, 33, 512])
def test_int8_matmul_plans_match_plain_and_repeat(cuda, m, n, k):
    """Every tile and split the plan picks (decode M 1-16, prefill 33 and
    512) against the plain version; two calls bit-equal (the cluster sums
    its ranks in a fixed order)."""
    rng = np.random.RandomState(m + n + k)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(cuda)
    wi, s = quantize_weight_int8(
        torch.from_numpy((0.02 * rng.randn(k, n)).astype(np.float32)).to(cuda))
    got = int8_matmul.dequant_matmul(x, wi, s)
    again = int8_matmul.dequant_matmul(x, wi, s)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, int8_matmul._plain(x, wi, s), **TOL)
    assert torch.equal(got, again)


def test_int8_matmul_allocates_only_its_output_at_decode(cuda):
    """One decode-M call allocates its (M, N) output and nothing else: no
    split-K partial buffer (the allocator rounds to 512 bytes)."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(8, 4096).astype(np.float32)).to(cuda)
    wi, s = quantize_weight_int8(torch.from_numpy(
        (0.02 * rng.randn(4096, 3072)).astype(np.float32)).to(cuda))
    int8_matmul.dequant_matmul(x, wi, s)  # build and load first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    y = int8_matmul.dequant_matmul(x, wi, s)
    torch.cuda.synchronize()
    out = -(-y.numel() * 4 // 512) * 512
    assert torch.cuda.max_memory_allocated() - before <= out


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
    with pytest.raises(TypeError):     # float64 is not a kernel type
        int8_matmul.dequant_matmul(
            x.to(torch.float64),
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


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_paged_attention_block_sizes_and_head_dims(cuda, bs, d):
    """Block sizes 8-64 and head dims 32-256, ragged positions with
    sentinel tails (one slot sees a single row); two calls bit-equal."""
    pos = [0, 37, 200, 511]
    rng = np.random.RandomState(bs + d)
    nb = 512 // bs
    args = [a.to(cuda) for a in _paged_case(rng, 4, nb * 4, bs, 4, d, nb,
                                            pos)]
    got = pa.paged_attention(*args)
    again = pa.paged_attention(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, pa._plain(*args), **TOL)
    assert torch.equal(got, again)


def test_paged_attention_long_context(cuda):
    """max_len 4096 (a 256-entry table of 16-row blocks): a slot at pos
    4095, one at pos 0, the rest ragged; two calls bit-equal."""
    pos = [4095, 0, 2047, 3000, 17, 1023, 4000, 64]
    rng = np.random.RandomState(4096)
    args = [a.to(cuda) for a in _paged_case(rng, 8, 8 * 256, 16, 16, 64,
                                            256, pos)]
    got = pa.paged_attention(*args)
    again = pa.paged_attention(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, pa._plain(*args), **TOL)
    assert torch.equal(got, again)


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


def test_int8_matmul_unaligned_x(cuda):
    """x that starts 4 bytes into its storage cannot go by 16-byte bulk
    copies: the kernel stages it 4 bytes at a time and agrees all the
    same."""
    rng = np.random.RandomState(8)
    flat = torch.from_numpy(rng.randn(1 + 8 * 1024).astype(np.float32)).to(cuda)
    x = flat[1:].view(8, 1024)
    wi, s = quantize_weight_int8(torch.from_numpy(
        (0.02 * rng.randn(1024, 1024)).astype(np.float32)).to(cuda))
    torch.testing.assert_close(int8_matmul.dequant_matmul(x, wi, s),
                               int8_matmul._plain(x, wi, s), **TOL)


def test_paged_attention_offset_views(cuda):
    """Pools that start 16 bytes into their storage are taken; pools that
    start 4 bytes in are refused (16-byte K/V loads); a q that starts 4
    bytes in is taken (staged 4 bytes at a time)."""
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
    flat = torch.zeros(1 + q.numel(), device=cuda)
    q_off = flat[1:].view(q.shape)
    q_off.copy_(q)
    torch.testing.assert_close(
        pa.paged_attention(q_off, kpool, vpool, tables, pos),
        pa._plain(q, kpool, vpool, tables, pos), **TOL)


# ---------------------------------------------------------------------------
# K3 / K4 on bf16 operands
# ---------------------------------------------------------------------------

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f16": torch.float16}


def _assert_bf16(got, want):
    assert got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.parametrize("q_dt,kv_dt", [("bf16", "bf16"), ("f32", "bf16"),
                                        ("bf16", "f32")])
@pytest.mark.parametrize("s,bs,h,d,pos", [
    (8, 16, 16, 64, [17, 100, 511, 512, 700, 1000, 0, 15]),
    (3, 4, 2, 32, [0, 5, 9]),
    (2, 8, 4, 128, [63, 30]),
    (1, 16, 1, 256, [200]),
    (2, 8, 3, 96, [90, 7]),
    (2, 16, 1, 160, [300, 40]),
])
def test_paged_attention_bf16_matches_plain_and_repeats(cuda, q_dt, kv_dt,
                                                        s, bs, h, d, pos):
    """Every dtype pair with a bf16 side (q and the pools independently;
    the output in q's dtype), head dims 32-256 (96 and 160: rows per tile
    that do not split evenly over the P.V threads); two calls bit-equal."""
    rng = np.random.RandomState(len(pos) + d + 1)
    nb = -(-(max(pos) + 1) // bs) + 2
    q, kp, vp, tables, p = [a.to(cuda) for a in
                            _paged_case(rng, s, nb * s, bs, h, d, nb, pos)]
    q = q.to(DTYPES[q_dt])
    kp, vp = kp.to(DTYPES[kv_dt]), vp.to(DTYPES[kv_dt])
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, kp, vp, tables, p)
    again = pa.paged_attention(q, kp, vp, tables, p)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 2
    _assert_bf16(got, pa._plain(q, kp, vp, tables, p))
    assert torch.equal(got, again)


def test_paged_attention_bf16_long_context(cuda):
    pos = [4095, 0, 2047, 3000, 17, 1023, 4000, 64]
    rng = np.random.RandomState(4097)
    q, kp, vp, tables, p = [
        a.to(cuda) for a in _paged_case(rng, 8, 8 * 256, 16, 16, 64, 256,
                                        pos)]
    q, kp, vp = (t.to(torch.bfloat16) for t in (q, kp, vp))
    got = pa.paged_attention(q, kp, vp, tables, p)
    torch.cuda.synchronize()
    _assert_bf16(got, pa._plain(q, kp, vp, tables, p))


@pytest.mark.parametrize("q_dt", ["f32", "bf16"])
def test_paged_attention_bf16_offset_views(cuda, q_dt):
    """bf16 pools that start 16 bytes into their storage are taken, 2
    bytes in are refused; a q that starts 2 or 4 bytes in (bf16) or 4
    bytes in (f32) is taken (staged element by element) and agrees."""
    rng = np.random.RandomState(16)
    q, kp, vp, tables, p = [
        a.to(cuda) for a in _paged_case(rng, 2, 6, 4, 2, 32, 3, [9, 3])]
    q = q.to(DTYPES[q_dt])
    kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    want = pa._plain(q, kp, vp, tables, p)

    def at(src, offset):
        flat = torch.zeros(offset + src.numel(), dtype=src.dtype,
                           device=cuda)
        view = flat[offset:].view(src.shape)
        view.copy_(src)
        return view
    _assert_bf16(pa.paged_attention(q, at(kp, 8), at(vp, 8), tables, p),
                 want)
    with pytest.raises(ValueError, match="aligned"):
        pa.paged_attention(q, at(kp, 1), vp, tables, p)
    for off in ((1, 2) if q_dt == "bf16" else (1,)):
        _assert_bf16(pa.paged_attention(at(q, off), kp, vp, tables, p),
                     want)


def test_paged_attention_rejects_mixed_pools(cuda):
    q = torch.zeros(2, 2, 32, device=cuda)
    pool = torch.zeros(4, 4, 2, 32, device=cuda)
    tables = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        pa.paged_attention(q, pool, pool.to(torch.bfloat16), tables, pos)
    with pytest.raises(TypeError):     # float64 is not a kernel type
        pa.paged_attention(q.double(), pool, pool, tables, pos)


@pytest.mark.parametrize("k", [1024, 4096])
@pytest.mark.parametrize("n", [16, 1024, 3072])
@pytest.mark.parametrize("m", [1, 8, 16, 33, 512])
def test_int8_matmul_bf16_plans_match_plain_and_repeat(cuda, m, n, k):
    """bf16 x at every tile and split the plan picks: y in bf16, within 2
    bf16 units of the plain version; two calls bit-equal."""
    rng = np.random.RandomState(m + n + k + 1)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(cuda).to(
        torch.bfloat16)
    wi, s = quantize_weight_int8(
        torch.from_numpy((0.02 * rng.randn(k, n)).astype(np.float32)).to(cuda))
    before = int8_matmul.dequant_matmul.launches
    got = int8_matmul.dequant_matmul(x, wi, s)
    again = int8_matmul.dequant_matmul(x, wi, s)
    torch.cuda.synchronize()
    assert int8_matmul.dequant_matmul.launches == before + 2
    _assert_bf16(got, int8_matmul._plain(x, wi, s))
    assert torch.equal(got, again)


@pytest.mark.parametrize("offset,k", [(1, 1024), (4, 1024), (0, 36),
                                      (0, 1028)])
def test_int8_matmul_bf16_unaligned_x(cuda, offset, k):
    """bf16 x rows that are no whole 16-byte chunks cannot go by bulk
    copy: x starting 2 or 8 bytes into its storage, or K not a multiple
    of 8 (K 36, 1028: whole chunks in f32, not in bf16).  The kernel
    stages them element by element and agrees all the same."""
    rng = np.random.RandomState(offset + k)
    flat = torch.from_numpy(rng.randn(offset + 8 * k).astype(np.float32)).to(
        cuda).to(torch.bfloat16)
    x = flat[offset:].view(8, k)
    wi, s = quantize_weight_int8(torch.from_numpy(
        (0.02 * rng.randn(k, 1024)).astype(np.float32)).to(cuda))
    got = int8_matmul.dequant_matmul(x, wi, s)
    torch.cuda.synchronize()
    _assert_bf16(got, int8_matmul._plain(x, wi, s))


def test_int8_matmul_bf16_batch_dims_and_per_tensor_scale(cuda):
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.randn(2, 3, 64).astype(np.float32)).to(cuda).to(
        torch.bfloat16)
    wi, s = quantize_weight_int8(torch.from_numpy(
        rng.randn(64, 128).astype(np.float32)).to(cuda), per_channel=False)
    got = int8_matmul.dequant_matmul(x, wi, s)
    assert got.shape == (2, 3, 128) and got.dtype == torch.bfloat16
    _assert_bf16(got, int8_matmul._plain(x.reshape(6, 64), wi,
                                         s.reshape(1, 1).expand(1, 128))
                 .reshape(2, 3, 128))


# ---------------------------------------------------------------------------
# K3 / K4 on float16 operands
# ---------------------------------------------------------------------------

def _assert_f16(got, want):
    assert got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), **F16_TOL)


@pytest.mark.parametrize("q_dt,kv_dt", [("f16", "f16"), ("f32", "f16"),
                                        ("f16", "f32"), ("f16", "bf16")])
@pytest.mark.parametrize("s,bs,h,d,pos", [
    (8, 16, 16, 64, [17, 100, 511, 512, 700, 1000, 0, 15]),
    (3, 4, 2, 32, [0, 5, 9]),
    (1, 16, 1, 256, [200]),
    (2, 8, 3, 96, [90, 7]),
])
def test_paged_attention_f16_matches_plain_and_repeats(cuda, q_dt, kv_dt,
                                                       s, bs, h, d, pos):
    """Every dtype pair with a float16 side runs the kernel (no plain
    version on the card): the output in q's dtype, two calls bit-equal."""
    rng = np.random.RandomState(len(pos) + d + 2)
    nb = -(-(max(pos) + 1) // bs) + 2
    q, kp, vp, tables, p = [a.to(cuda) for a in
                            _paged_case(rng, s, nb * s, bs, h, d, nb, pos)]
    q = q.to(DTYPES[q_dt])
    kp, vp = kp.to(DTYPES[kv_dt]), vp.to(DTYPES[kv_dt])
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, kp, vp, tables, p)
    again = pa.paged_attention(q, kp, vp, tables, p)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 2
    want = pa._plain(q, kp, vp, tables, p)
    if q.dtype == torch.float32:
        torch.testing.assert_close(got, want, **F16_TOL)
    else:
        _assert_f16(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("k", [1024, 4096])
@pytest.mark.parametrize("n", [16, 1024, 3072])
@pytest.mark.parametrize("m", [1, 8, 16, 33, 512])
def test_int8_matmul_f16_plans_match_plain_and_repeat(cuda, m, n, k):
    """float16 x at every tile and split the plan picks: y in float16,
    within one float16 unit of the plain version; two calls bit-equal."""
    rng = np.random.RandomState(m + n + k + 2)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(cuda).to(
        torch.float16)
    wi, s = quantize_weight_int8(
        torch.from_numpy((0.02 * rng.randn(k, n)).astype(np.float32)).to(cuda))
    before = int8_matmul.dequant_matmul.launches
    got = int8_matmul.dequant_matmul(x, wi, s)
    again = int8_matmul.dequant_matmul(x, wi, s)
    torch.cuda.synchronize()
    assert int8_matmul.dequant_matmul.launches == before + 2
    _assert_f16(got, int8_matmul._plain(x, wi, s))
    assert torch.equal(got, again)


@pytest.mark.parametrize("offset,k", [(1, 1024), (0, 36)])
def test_int8_matmul_f16_unaligned_x(cuda, offset, k):
    """float16 x rows that are no whole 16-byte chunks are staged element
    by element, as bf16 ones are."""
    rng = np.random.RandomState(offset + k + 1)
    flat = torch.from_numpy(rng.randn(offset + 8 * k).astype(np.float32)).to(
        cuda).to(torch.float16)
    x = flat[offset:].view(8, k)
    wi, s = quantize_weight_int8(torch.from_numpy(
        (0.02 * rng.randn(k, 1024)).astype(np.float32)).to(cuda))
    got = int8_matmul.dequant_matmul(x, wi, s)
    torch.cuda.synchronize()
    _assert_f16(got, int8_matmul._plain(x, wi, s))


# ---------------------------------------------------------------------------
# K1 / K2: flash attention forward and backward
# ---------------------------------------------------------------------------
# f32: the kernels sum in another order than the plain version's einsums;
# outputs and the logsumexp within 1e-4 + 1e-4 * |plain|, gradients (sums
# over up to 1024 rows) within 2e-4 + 1e-3 * |plain|.  bf16: both round the
# same f32 values to bf16, so they may differ by one bf16 unit (2**-8
# relative): 1e-2 + 1e-2 * |plain|.  float16: the same argument with its
# units eight times finer (2**-11 relative): 2e-3 + 2e-3 * |plain|.
FLASH_TOL = {torch.float32: (dict(rtol=1e-4, atol=1e-4),
                             dict(rtol=1e-3, atol=2e-4)),
             torch.bfloat16: (dict(rtol=1e-2, atol=1e-2),
                              dict(rtol=1e-2, atol=1e-2)),
             torch.float16: (dict(rtol=2e-3, atol=2e-3),
                             dict(rtol=2e-3, atol=2e-3))}


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
    # bf16 runs the tensor-core kernels: every head_dim, both causal
    # settings, bias, segment ids, dropout and Sq != Sk
    (2, 256, 256, 2, 64, torch.bfloat16, False, True, False, 0.0),
    (2, 256, 256, 2, 64, torch.bfloat16, False, False, True, 0.15),
    (1, 128, 384, 2, 64, torch.bfloat16, True, False, False, 0.1),
    (2, 256, 256, 2, 128, torch.bfloat16, True, False, False, 0.0),
    (1, 128, 384, 2, 128, torch.bfloat16, True, True, False, 0.2),
    (2, 256, 256, 2, 128, torch.bfloat16, False, False, True, 0.1),
    (1, 256, 256, 2, 256, torch.bfloat16, True, False, False, 0.0),
    (1, 128, 384, 2, 256, torch.bfloat16, True, True, False, 0.2),
    # float16 runs the same tensor-core kernels: the training shape, every
    # head_dim, bias, segment ids, dropout, Sq != Sk and a dQ over many
    # key tiles
    (4, 1024, 1024, 16, 64, torch.float16, True, False, False, 0.1),
    (2, 256, 256, 2, 64, torch.float16, False, True, False, 0.0),
    (2, 256, 256, 2, 64, torch.float16, False, False, True, 0.15),
    (1, 128, 384, 2, 64, torch.float16, True, False, False, 0.1),
    (2, 256, 256, 2, 128, torch.float16, True, True, False, 0.1),
    (2, 256, 256, 2, 128, torch.float16, False, False, True, 0.0),
    (1, 256, 256, 2, 256, torch.float16, False, True, True, 0.1),
    (1, 128, 384, 2, 256, torch.float16, True, True, False, 0.2),
    (1, 128, 1024, 2, 64, torch.float16, False, True, False, 0.0),
    # Transformer-base's attention (the seq2seq path): B 16, H 8, D 64,
    # S 256, a per-key bias, dropout 0.1; its encoder self-attention and
    # its cross-attention have this one shape
    (16, 256, 256, 8, 64, torch.bfloat16, False, True, False, 0.1),
    (16, 256, 256, 8, 64, torch.float32, False, True, False, 0.1),
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_seq2seq_padding_mask_matches_plain(cuda, dtype):
    """K1 / K2 at the seq2seq path's shape with its own mask: the (B, 1,
    1, S) source padding mask (-1e9 past each length, lengths 64..256) as
    the per-key bias, dropout 0.1."""
    from paddle_tpu_torch.nn.functional.attention import _flash_kv_bias
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do, _, _, _ = _flash_case(cuda, 16, 256, 256, 8, 64, dtype,
                                       seed=23)
    lens = np.random.RandomState(24).randint(64, 257, 16)
    mask = np.where(np.arange(256)[None] < lens[:, None], 0.0, -1e9)
    bias = _flash_kv_bias(torch.from_numpy(mask.astype(np.float32)).to(
        cuda)[:, None, None, :], 16, 256)
    seed = torch.tensor([20261019], dtype=torch.int32, device=cuda)
    o, lse = fa.flash_fwd(q, k, v, bias, None, None, seed, False, 0.1)
    grads = fa.flash_bwd(q, k, v, bias, None, None, seed, o, lse, do,
                         False, 0.1)
    po, plse = fa._plain_fwd(q, k, v, bias, None, None, seed, False, 0.1)
    pgrads = fa._plain_bwd(q, k, v, bias, None, None, seed, o, lse, do,
                           False, 0.1)
    tol_o, tol_g = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), po.float(), **tol_o)
    torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-4)
    for g, pg in zip(grads, pgrads):   # dq, dk, dv, dbias
        torch.testing.assert_close(g.float(), pg.float(), **tol_g)


def test_flash_bf16_backward_repeats_bit_for_bit(cuda):
    """K2 sums dQ, dK, dV and dbias in fixed orders with no atomics: two
    calls on the same inputs give bit-equal gradients."""
    _flash_backward_repeats(cuda, torch.bfloat16)


def test_flash_f16_backward_repeats_bit_for_bit(cuda):
    """The float16 route sums in the same fixed orders."""
    _flash_backward_repeats(cuda, torch.float16)


def _flash_backward_repeats(cuda, dtype):
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do, bi, _, _ = _flash_case(cuda, 2, 512, 512, 4, 64,
                                        dtype, bias=True, seed=4)
    seed = torch.tensor([77], dtype=torch.int32, device=cuda)
    o, lse = fa.flash_fwd(q, k, v, bi, None, None, seed, True, 0.1)
    first = fa.flash_bwd(q, k, v, bi, None, None, seed, o, lse, do, True,
                         0.1)
    second = fa.flash_bwd(q, k, v, bi, None, None, seed, o, lse, do, True,
                          0.1)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_bf16_backward_allocates_no_dq_partials(cuda):
    """A bf16 K2 call allocates its outputs, delta and the dbias rows, and
    no f32 dQ partial buffer (Sk / 64 slices of the f32 dQ)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    b, s, h, d = 2, 1024, 4, 64
    q, k, v, do, bi, _, _ = _flash_case(cuda, b, s, s, h, d, torch.bfloat16,
                                        bias=True, seed=5)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    o, lse = fa.flash_fwd(q, k, v, bi, None, None, seed, True, 0.0)
    fa.flash_bwd(q, k, v, bi, None, None, seed, o, lse, do, True, 0.0)
    torch.cuda.synchronize()     # the library is built and loaded
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = fa.flash_bwd(q, k, v, bi, None, None, seed, o, lse, do, True,
                         0.0)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    partials = (s // 64) * b * h * s * d * 4
    outputs = 3 * q.numel() * 2 + b * h * s * 4 + 2 * b * h * s * 4
    assert extra <= outputs + (1 << 20) < partials, (extra, outputs)
    del grads


def test_flash_bf16_unaligned_views_are_copied(cuda):
    """A bf16 view whose rows do not start on 16 bytes is copied before the
    16-byte tile copies; the result equals the aligned input's."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do, _, _, _ = _flash_case(cuda, 1, 128, 128, 2, 64,
                                       torch.bfloat16, seed=6)
    flat = torch.zeros(q.numel() + 4, dtype=q.dtype, device=cuda)
    shifted = flat[4:].view(q.shape)   # starts 8 bytes into its storage
    shifted.copy_(q)
    seed = torch.zeros(1, dtype=torch.int32, device=cuda)
    want, _ = fa.flash_fwd(q, k, v, None, None, None, seed, True, 0.0)
    got, _ = fa.flash_fwd(shifted, k, v, None, None, None, seed, True, 0.0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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


def test_naive_attention_in_float16_on_the_card(cuda):
    """A shape the flash gate refuses takes the naive path; in float16 its
    masked scores are -inf (the reference's -1e30 cast to float16, which
    torch.full refuses as an overflow), and the output is the f32 path's
    within float16 rounding."""
    from paddle_tpu_torch.nn.functional import attention as A
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 20, 2, 32).astype(
        np.float32)).to(cuda) for _ in range(3))
    want = A.scaled_dot_product_attention(q, k, v, is_causal=True)
    got = A.scaled_dot_product_attention(q.half(), k.half(), v.half(),
                                         is_causal=True)
    assert got.dtype == torch.float16
    torch.testing.assert_close(got.float(), want, rtol=2e-3, atol=2e-3)


def test_flash_rejects_what_the_kernels_do_not_take(cuda):
    from paddle_tpu_torch.ops import flash_attention as fa
    q = torch.zeros(1, 128, 2, 64, device=cuda)
    seed = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):      # float64 is not a kernel type
        fa.flash_fwd(q.double(), q.double(), q.double(), None, None, None,
                     seed, False, 0.0)
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


# ---------------------------------------------------------------------------
# K5-K9: fused training BatchNorm
# ---------------------------------------------------------------------------
# The elementwise kernels round x*a + b like the plain version (no fused
# multiply-add), so their outputs and activation masks match it; the column
# sums (K5, K7) add over up to 3.2 M rows in another order.  f32: within
# 1e-5 of each tensor's largest |value|; bf16 outputs: within one bf16 unit,
# 1e-2 + 1e-2 * |plain|.

def _assert_bn(got, want):
    if want.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-2)
    else:
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max()) or 1.0
        assert err <= 1e-5 * scale, (err, scale)


def _bn_rows(cuda, m, c, dtype, seed, shift=0.5):
    rng = np.random.RandomState(seed)
    t = rng.randn(m, c).astype(np.float32) * 1.5 + shift
    return torch.from_numpy(t).to(cuda).to(dtype)


def _bn_coef(cuda, c, seed, backward=False):
    rng = np.random.RandomState(seed)
    rows = [rng.rand(c) + 0.5, rng.randn(c), 0.3 * rng.randn(c),
            rng.rand(c) + 0.5]
    rows += [rng.randn(c) for _ in range(3)] if backward else \
        [np.zeros(c)] * 3
    rows.append(np.zeros(c))
    return torch.from_numpy(np.stack(rows).astype(np.float32)).to(cuda)


BN_SHAPES = [(1037, 24), (515, 40), (333, 7), (3001, 64), (12544, 2048)]


@pytest.mark.parametrize("m,c", BN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_stats_kernel_matches_plain(cuda, m, c, dtype):
    x = _bn_rows(cuda, m, c, dtype, m + c)
    n = fbn.bn_stats.launches
    got = fbn.bn_stats(x)
    torch.cuda.synchronize()
    assert fbn.bn_stats.launches == n + 1
    for g, w in zip(got, fbn._plain_stats(x)):
        _assert_bn(g, w)


def test_bn_column_sums_are_bit_equal_run_to_run(cuda):
    """K5 and K7 add their per-chunk partials in a fixed order (no
    atomics): two calls give bit-equal sums."""
    m, c = 3 * 64 * 112 * 112, 64           # three stem images
    x = _bn_rows(cuda, m, c, torch.bfloat16, 13)
    g = _bn_rows(cuda, m, c, torch.bfloat16, 14, shift=0.0)
    coef = _bn_coef(cuda, c, 15, backward=True)
    for a, b in zip(fbn.bn_stats(x) + fbn.bn_bwd_reduce(g, x, coef),
                    fbn.bn_stats(x) + fbn.bn_bwd_reduce(g, x, coef)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m,c", BN_SHAPES[:4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "relu", "relu6"])
@pytest.mark.parametrize("res", ["none", "plain", "dual"])
def test_bn_elementwise_kernels_match_plain(cuda, m, c, dtype, act, res):
    """K6, K7 and K8 on the same inputs as their plain versions."""
    x = _bn_rows(cuda, m, c, dtype, 1)
    g = _bn_rows(cuda, m, c, dtype, 2, shift=0.0)
    r = None if res == "none" else _bn_rows(cuda, m, c, dtype, 3)
    coef = _bn_coef(cuda, c, 4, backward=True)
    coefr = _bn_coef(cuda, c, 5, backward=True) if res == "dual" else None
    counts = [f.launches for f in (fbn.bn_apply, fbn.bn_bwd_reduce,
                                   fbn.bn_bwd_dx)]
    y = fbn.bn_apply(x, coef, r, act, coefr)
    sums = fbn.bn_bwd_reduce(g, x, coef, r, act, coefr)
    dx, dres = fbn.bn_bwd_dx(g, x, coef, r, act, coefr)
    torch.cuda.synchronize()
    assert [f.launches for f in (fbn.bn_apply, fbn.bn_bwd_reduce,
                                 fbn.bn_bwd_dx)] == [n + 1 for n in counts]
    _assert_bn(y, fbn._plain_apply(x, coef, r, act, coefr))
    want = fbn._plain_bwd_reduce(g, x, coef, r, act, coefr)
    assert len(sums) == len(want) == (3 if res == "dual" else 2)
    for s, w in zip(sums, want):
        _assert_bn(s, w)
    pdx, pdres = fbn._plain_bwd_dx(g, x, coef, r, act, coefr)
    _assert_bn(dx, pdx)
    assert (dres is None) == (pdres is None)
    if dres is not None:
        _assert_bn(dres, pdres)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_kernels_at_a_main_path_shape(cuda, dtype):
    """layer1's bn3 with its residual: M = 64 * 56 * 56 rows (batch 64),
    C = 256, relu."""
    m, c = 64 * 56 * 56, 256
    x = _bn_rows(cuda, m, c, dtype, 6)
    g = _bn_rows(cuda, m, c, dtype, 7, shift=0.0)
    r = _bn_rows(cuda, m, c, dtype, 8)
    coef = _bn_coef(cuda, c, 9, backward=True)
    for got, want in zip(fbn.bn_stats(x), fbn._plain_stats(x)):
        _assert_bn(got, want)
    _assert_bn(fbn.bn_apply(x, coef, r, "relu"),
               fbn._plain_apply(x, coef, r, "relu"))
    for got, want in zip(fbn.bn_bwd_reduce(g, x, coef, r, "relu"),
                         fbn._plain_bwd_reduce(g, x, coef, r, "relu")):
        _assert_bn(got, want)
    for got, want in zip(fbn.bn_bwd_dx(g, x, coef, r, "relu"),
                         fbn._plain_bwd_dx(g, x, coef, r, "relu")):
        _assert_bn(got, want)


@pytest.mark.parametrize("shape", [(2, 9, 11, 24), (3, 8, 8, 40),
                                   (1, 7, 5, 3), (4, 112, 112, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "relu", "relu6"])
@pytest.mark.parametrize("pool", [("max", (3, 3), (2, 2), (1, 1)),
                                  ("avg", (3, 3), (2, 2), (1, 1)),
                                  ("max", (2, 3), (2, 1), (0, 1))])
def test_bn_pool_kernel_matches_plain(cuda, shape, dtype, act, pool):
    """K9 (the ring route at these shapes); max is exact, avg sums its
    window like the plain version, from values rounded to x's dtype."""
    n, h, w, c = shape
    x = _bn_rows(cuda, n * h * w, c, dtype, 10).view(n, h, w, c)
    coef = _bn_coef(cuda, c, 11)
    kind, k, s, p = pool
    before = fbn.bn_pool_apply.launches
    got = fbn.bn_pool_apply(x, coef, act, kind, k, s, p)
    torch.cuda.synchronize()
    assert fbn.bn_pool_apply.launches == before + 1
    want = fbn._plain_pool_apply(x, coef, act, kind, k, s, p)
    assert got.shape == want.shape and got.dtype == want.dtype
    _assert_bn(got, want)


POOLS = [("max", (3, 3), (2, 2), (1, 1)), ("avg", (3, 3), (2, 2), (1, 1)),
         ("max", (2, 3), (2, 1), (0, 1))]


def _assert_pool_avg(got, want):
    """A K9 average against its plain version: f32 as _assert_bn; bf16
    (both sum in f32 and round once) within one bf16 unit of the larger
    value, 2**-7 of it, plus 1e-5 of the largest |value| for f32 sums
    taken in another order."""
    if want.dtype != torch.bfloat16:
        _assert_bn(got, want)
        return
    g, w = got.float(), want.float()
    bound = 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 1e-5 * float(
        w.abs().max())
    assert bool(((g - w).abs() <= bound).all()), float((g - w).abs().max())


@pytest.mark.parametrize("shape,dtype,route", [
    ((4, 112, 112, 64), torch.bfloat16, "ring"),   # stem rows, bulk copies
    ((2, 9, 11, 24), torch.float32, "ring"),
    ((1, 7, 5, 3), torch.float32, "ring"),  # 60-byte rows: element path
    ((1, 7, 5, 3), torch.bfloat16, "ring"),  # 30-byte rows
    ((2, 6, 240, 64), torch.float32, "window"),  # 61,440-byte rows: the
    ((2, 6, 480, 64), torch.bfloat16, "window"),  # ring holds < 4 of them
])
@pytest.mark.parametrize("pool", POOLS)
def test_bn_pool_routes_match_plain_and_repeat(cuda, shape, dtype, route,
                                               pool):
    """K9 takes the ring route where the row slots fit, else the window
    route (counted per route), and a bf16 average the window route; max
    is bit-equal to the plain version (max of rounded values is the
    rounded max), avg within _assert_pool_avg's bound; two calls
    bit-equal."""
    n, h, w, c = shape
    x = _bn_rows(cuda, n * h * w, c, dtype, 20).view(n, h, w, c)
    coef = _bn_coef(cuda, c, 21)
    kind, k, s, p = pool
    if kind == "avg" and dtype == torch.bfloat16:
        route = "window"
    before = dict(fbn.bn_pool_apply.routes)
    got = fbn.bn_pool_apply(x, coef, "relu", kind, k, s, p)
    again = fbn.bn_pool_apply(x, coef, "relu", kind, k, s, p)
    torch.cuda.synchronize()
    assert fbn.bn_pool_apply.routes[route] == before[route] + 2
    want = fbn._plain_pool_apply(x, coef, "relu", kind, k, s, p)
    assert got.shape == want.shape and got.dtype == want.dtype
    if kind == "max":
        assert torch.equal(got, want)
    else:
        _assert_pool_avg(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("shape,dtype,pool", [
    ((2, 14, 14, 64), torch.float32, ("avg", (14, 14), (1, 1), (0, 0))),
    ((2, 10, 10, 32), torch.bfloat16, ("max", (9, 9), (1, 1), (0, 0))),
    ((1, 40, 40, 16), torch.float32, ("max", (17, 17), (3, 3), (2, 2))),
])
def test_bn_pool_deep_rings_match_plain(cuda, shape, dtype, pool):
    """Windows of 9 to 17 rows take rings of 18 to 34 slots, more than 128
    bytes of mbarriers hold: each slot keeps its own barrier."""
    n, h, w, c = shape
    x = _bn_rows(cuda, n * h * w, c, dtype, 24).view(n, h, w, c)
    coef = _bn_coef(cuda, c, 25)
    before = fbn.bn_pool_apply.routes["ring"]
    got = fbn.bn_pool_apply(x, coef, "relu", *pool)
    again = fbn.bn_pool_apply(x, coef, "relu", *pool)
    torch.cuda.synchronize()
    assert fbn.bn_pool_apply.routes["ring"] == before + 2
    want = fbn._plain_pool_apply(x, coef, "relu", *pool)
    assert got.shape == want.shape
    if pool[0] == "max":
        assert torch.equal(got, want)
    else:
        _assert_pool_avg(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_pool_unaligned_input_takes_the_element_path(cuda, dtype):
    """An input that starts 4 bytes into its storage cannot go by bulk
    copies: the ring route reads its rows element by element."""
    n, h, w, c = 2, 10, 12, 16
    flat = _bn_rows(cuda, n * h * w * c + 2, 1, dtype, 22).view(-1)
    x = flat[4 // flat.element_size():][:n * h * w * c].view(n, h, w, c)
    coef = _bn_coef(cuda, c, 23)
    before = fbn.bn_pool_apply.routes["ring"]
    got = fbn.bn_pool_apply(x, coef, "relu6", *POOLS[0])
    torch.cuda.synchronize()
    assert fbn.bn_pool_apply.routes["ring"] == before + 1
    assert torch.equal(got, fbn._plain_pool_apply(x, coef, "relu6",
                                                  *POOLS[0]))


def _grads_of(fn, ins, cts):
    ins = [t.detach().clone().requires_grad_() for t in ins]
    outs = fn(*ins)
    grads = torch.autograd.grad(outs, ins, cts)
    return [o.detach() for o in outs], list(grads)


@pytest.mark.parametrize("shape,dtype", [
    ((3, 24, 7, 9), torch.float32), ((2, 40, 5, 11), torch.bfloat16),
    ((64, 256, 56, 56), torch.bfloat16)])
@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("form", ["single", "residual", "dual", "pool"])
def test_bn_functions_match_plain_autograd(cuda, shape, dtype, act, form):
    """bn_act_train / bn2_act_train / bn_act_pool_train (their kernels in
    both directions) against autograd of the plain references: outputs,
    f32 statistics and the gradients of x, gamma, beta and the residual,
    for a logical NCHW input in channels_last memory.  The statistics enter
    every output, so the tolerances are those of the statistics: f32
    within 1e-4 of each tensor's largest |value|; bf16 2e-2 of it plus
    2e-2 * |plain|."""
    if form == "pool" and shape[1] > 64:
        pytest.skip("the pooled stem is the only pooled site")
    rng = np.random.RandomState(12)
    n, c, h, w = shape

    def act_t(*s):
        t = torch.from_numpy(rng.randn(*s).astype(np.float32) + 0.3)
        return t.to(cuda).to(dtype).contiguous(
            memory_format=torch.channels_last)
    x, r = act_t(n, c, h, w), act_t(n, c, h, w)
    gamma = torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5).to(cuda)
    beta = torch.from_numpy(rng.randn(c).astype(np.float32)).to(cuda)
    gr = torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5).to(cuda)
    br = torch.from_numpy(rng.randn(c).astype(np.float32)).to(cuda)
    cm = torch.from_numpy(rng.randn(c).astype(np.float32)).to(cuda)
    pool = ("max", 3, 2, 1)
    if form == "single":
        ins = [x, gamma, beta]
        k = lambda x, g, b: fbn.bn_act_train(x, g, b, 1e-5, act, None, False)
        p = lambda x, g, b: fbn.bn_act_reference(x, g, b, 1e-5, act, None, 1)
    elif form == "residual":
        ins = [x, gamma, beta, r]
        k = lambda x, g, b, r: fbn.bn_act_train(x, g, b, 1e-5, act, r, False)
        p = lambda x, g, b, r: fbn.bn_act_reference(x, g, b, 1e-5, act, r, 1)
    elif form == "dual":
        ins = [x, gamma, beta, r, gr, br]
        k = lambda *a: fbn.bn2_act_train(*a, 1e-5, act, False)
        p = lambda *a: fbn.bn2_act_reference(*a, 1e-5, act, 1)
    else:
        ins = [x, gamma, beta]
        k = lambda x, g, b: fbn.bn_act_pool_train(x, g, b, 1e-5, act, pool,
                                                  False)
        p = lambda x, g, b: fbn.bn_act_pool_reference(x, g, b, 1e-5, act,
                                                      pool, 1)
    with torch.no_grad():
        y0 = p(*ins)
    cts = [act_t(*y0[0].shape)] + [cm * 0.1 for _ in y0[1:]]
    relayouts = fbn.bn_act_train.relayouts + fbn.bn2_act_train.relayouts
    kout, kgrads = _grads_of(k, ins, cts)
    pout, pgrads = _grads_of(p, ins, cts)
    torch.cuda.synchronize()
    assert fbn.bn_act_train.relayouts + fbn.bn2_act_train.relayouts == \
        relayouts
    for got, want in zip(kout + kgrads, pout + pgrads):
        assert got.shape == want.shape and got.dtype == want.dtype
        got, want = got.float(), want.float()
        scale = float(want.abs().max())
        if dtype == torch.bfloat16:
            bad = (got - want).abs() > 2e-2 * scale + 2e-2 * want.abs()
        else:
            bad = (got - want).abs() > 1e-4 * scale
        # the two paths sum the batch statistics in other orders, so where
        # the pre-activation lies within a rounding of 0 the activation's
        # mask may differ: at most one element in a million may differ so
        assert int(bad.sum()) <= max(0, got.numel() // 1_000_000), (
            int(bad.sum()), float((got - want).abs().max()), scale)


def test_bn_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(16, 8, device=cuda)
    coef = torch.zeros(8, 8, device=cuda)
    with pytest.raises(TypeError):
        fbn.bn_stats(x.half())
    with pytest.raises(ValueError):
        fbn.bn_stats(x.t())                              # not (M, C) rows
    with pytest.raises(ValueError):
        fbn.bn_apply(x, coef[:4])                        # coef not (8, C)
    with pytest.raises(ValueError):
        fbn.bn_apply(x, coef, x.cpu())                   # residual on CPU
    with pytest.raises(ValueError):
        fbn.bn_bwd_dx(x[:8], x, coef)                    # g of another shape


# ---------------------------------------------------------------------------
# the serving engine's captured programs (CUDA graphs)
# ---------------------------------------------------------------------------
# decode logits (here the log-probs of the picked tokens) of a replayed
# graph against the same program run uncaptured: f32 within 2e-3 (the
# chip smoke test's LOGIT_TOL), bf16 within 5% of their largest |value|
LOGIT_TOL = 2e-3
BF16_LOGIT_TOL = 5e-2
ENGINE = dict(max_slots=4, max_len=128, prefill_buckets=(16, 64),
              decode_chunk=4, block_size=16)


def _serving_model(cuda, dtype, seed=3, layers=2):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.quantization import quantize_for_serving
    cfg = GPTConfig(vocab_size=1024, hidden_size=256,
                    num_hidden_layers=layers, num_attention_heads=4,
                    max_position_embeddings=256, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0, initializer_range=0.2)
    model = GPTForPretraining(cfg, device=cuda, seed=seed).eval()
    if dtype == torch.bfloat16:
        amp.decorate(models=model, level="O2", dtype="bfloat16")
    return quantize_for_serving(model)


def _traffic(eng, n=6):
    rng = np.random.RandomState(4)
    return [eng.submit(rng.randint(0, 1024, (int(rng.randint(3, 60)),)),
                       max_new_tokens=int(rng.randint(8, 40)),
                       **({"decode_strategy": "sampling", "seed": i,
                           "temperature": 0.9, "top_k": 50, "top_p": 0.95}
                          if i % 2 else {}))
            for i in range(n)]


@pytest.mark.parametrize("program", ["decode", "decode_greedy"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_engine_replayed_decode_matches_uncaptured(cuda, dt, program):
    """One decode chunk on the same state: the graph's replay and the same
    program run uncaptured give the same tokens bit for bit, log-probs
    and the written KV within the logit tolerance."""
    from paddle_tpu_torch.serving import ServingEngine
    dtype = DTYPES[dt]
    eng = ServingEngine(_serving_model(cuda, dtype), kv="paged", dtype=dtype,
                        device=cuda, **ENGINE)
    eng.warmup()
    _traffic(eng, 4)
    eng.step()                       # admits four, one decode chunk
    with torch.inference_mode():
        eng._ensure_decode_blocks()
        eng._rebuild_batch()
        eng._sync_tables(True)
        prog = eng._programs[program]
        state = [t.clone() for t in prog.inputs.values()]
        pools = [t.clone() for kv in eng._pool_store for t in kv]
        out = [t.clone() for t in prog.run(captured=True)[:3]]
        got_pools = [t.clone() for kv in eng._pool_store for t in kv]
        for buf, saved in zip(prog.inputs.values(), state):
            buf.copy_(saved)
        for t, saved in zip((t for kv in eng._pool_store for t in kv),
                            pools):
            t.copy_(saved)
        want = prog.run(captured=False)[:3]
    torch.cuda.synchronize()
    assert torch.equal(out[0], want[0])
    assert torch.equal(out[2], want[2]) and bool(want[2].all())
    tol = LOGIT_TOL if dtype == torch.float32 else \
        BF16_LOGIT_TOL * float(want[1].abs().max())
    assert float((out[1] - want[1]).abs().max()) <= tol
    for a, b in zip(got_pools, (t for kv in eng._pool_store for t in kv)):
        assert float((a.float() - b.float()).abs().max()) <= tol


@pytest.mark.parametrize("kv", ["fixed", "paged"])
def test_engine_captured_streams_equal_uncaptured_and_nothing_recaptured(
        cuda, kv):
    """Greedy and sampled traffic with churn and mid-decode OOM preemption
    (paged, a 12-block pool): the captured engine's streams equal the
    uncaptured path's, and no program is captured after warmup."""
    from paddle_tpu_torch.serving import ServingEngine
    model = _serving_model(cuda, torch.float32)
    extra = dict(num_blocks=12) if kv == "paged" else {}
    streams = []
    for uncaptured in (False, True):
        eng = ServingEngine(model, kv=kv, device=cuda, **ENGINE, **extra)
        eng._run_uncaptured = uncaptured
        report = eng.warmup()
        assert report["captured"]
        assert report["compile_counts"]["total"] == len(
            ENGINE["prefill_buckets"]) + 2
        resps = _traffic(eng, 8)
        eng.run_until_drained(timeout=300)
        streams.append([r.tokens(timeout=5) for r in resps])
        assert eng.post_warmup_compiles() == 0
        if kv == "paged":
            assert eng.metrics()["kv_pool"]["oom_preempts"] > 0, \
                "sanity: the small pool must run short"
    assert streams[0] == streams[1]


def _per_replay(prog):
    """A captured program's kernel launches per replay, by wrapper."""
    return {owner.__name__: n for (owner, key), n in prog.launches
            if key == "launches"}


def test_engine_replays_count_kernel_launches(cuda):
    """K3 / K4 launches counted through replays: each graph's per-replay
    counts (decode: one K3 and four K4 per layer and token; prefill: four
    K4 per layer) times its replays."""
    from paddle_tpu_torch.serving import ServingEngine
    eng = ServingEngine(_serving_model(cuda, torch.float32), kv="paged",
                        device=cuda, **ENGINE)
    eng.warmup()
    layers, chunk = 2, ENGINE["decode_chunk"]
    replays = {}
    for name, prog in eng._programs.items():
        decode = isinstance(name, str)
        want = {"dequant_matmul": 4 * layers * (chunk if decode else 1)}
        if decode:
            want["paged_attention"] = layers * chunk
        assert _per_replay(prog) == want
        replay = prog.graph.replay

        def counted(replay=replay, name=name):
            replays[name] = replays.get(name, 0) + 1
            replay()
        prog.graph.replay = counted
    pa.paged_attention.launches = int8_matmul.dequant_matmul.launches = 0
    _traffic(eng)
    eng.run_until_drained(timeout=300)
    eng.submit([1, 2, 3], max_new_tokens=9)        # an all-greedy batch
    eng.run_until_drained(timeout=60)
    assert replays.get("decode") and replays.get("decode_greedy")
    for wrapper in (pa.paged_attention, int8_matmul.dequant_matmul):
        want = sum(n * _per_replay(eng._programs[name]).get(
            wrapper.__name__, 0) for name, n in replays.items())
        assert wrapper.launches == want > 0


# the KV lifecycle on the captured engine: preemption, pool pressure and
# the prefix cache write the pools the graphs were captured on in place,
# so the replays see every restore, upload and copy-on-write.  Streams are
# compared token for token: K3 and K4 compute each decode row on its own
# at the fixed M of 8, and the sampler folds key and position.

def _long_traffic(eng, n=8):
    rng = np.random.RandomState(6)
    return [eng.submit(rng.randint(0, 1024, (int(rng.randint(3, 60)),)),
                       max_new_tokens=int(rng.randint(30, 60)),
                       **({"decode_strategy": "sampling", "seed": i,
                           "temperature": 0.9, "top_k": 50}
                          if i % 3 == 1 else {}))
            for i in range(n)]


@pytest.mark.parametrize("kv", ["fixed", "paged"])
def test_engine_preempt_restore_equals_uninterrupted(cuda, kv):
    """Every active run of a captured engine preempted after two steps and
    restored (in place, into other slots): every stream equals the
    uninterrupted engine's."""
    from paddle_tpu_torch.serving import ServingEngine
    model = _serving_model(cuda, torch.float32)
    streams = []
    for preempt in (False, True):
        eng = ServingEngine(model, kv=kv, device=cuda, **ENGINE)
        eng.warmup()
        resps = _long_traffic(eng, 6)
        eng.step()
        eng.step()
        if preempt:
            parked = [eng.preempt_slot(s) for s in sorted(eng._slots)]
            assert len(parked) == ENGINE["max_slots"] and not eng._slots
            for p in reversed(parked):
                assert eng.restore_run(p)
        eng.run_until_drained(timeout=300)
        streams.append([r.tokens(timeout=5) for r in resps])
        assert eng.post_warmup_compiles() == 0
    assert streams[0] == streams[1]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_engine_pool_pressure_equals_an_unpressured_engine(cuda, dt):
    """A captured paged engine on 10 blocks where 32 would back every slot
    parks and resumes runs (none fails), and every stream equals the same
    traffic on the full pool."""
    from paddle_tpu_torch.serving import ServingEngine
    dtype = DTYPES[dt]
    model = _serving_model(cuda, dtype)
    streams = []
    for extra in ({}, dict(num_blocks=10)):
        eng = ServingEngine(model, kv="paged", dtype=dtype, device=cuda,
                            **ENGINE, **extra)
        eng.warmup()
        resps = _long_traffic(eng)
        eng.run_until_drained(timeout=300)
        streams.append([r.tokens(timeout=5) for r in resps])
        kv = eng.metrics()["kv_pool"]
        assert kv["oom_failed"] == 0 and kv["oom_resumes"] == \
            kv["oom_preempts"]
        assert eng.post_warmup_compiles() == 0
    assert kv["oom_preempts"] > 0, "sanity: the small pool must run short"
    assert streams[0] == streams[1]


def _cached_blocks(eng):
    blocks = sorted(n.block for n in eng.prefix_cache._nodes.values())
    return {b: [t[b].clone() for pair in eng._pools for t in pair]
            for b in blocks}


def test_engine_prefix_cache_keeps_shared_blocks_and_captures_nothing(cuda):
    """Warm admissions (suffixes from a block boundary), a copy-on-write
    admission and their decode steps on the captured prefix engine: the
    blocks cached before them are unchanged bit for bit, the cache hits,
    nothing is captured after warmup, and the streams equal the same
    engine's uncaptured ones."""
    from paddle_tpu_torch.serving import ServingEngine
    model = _serving_model(cuda, torch.float32)
    rng = np.random.RandomState(8)
    template = rng.randint(0, 1024, (48,))
    prompts = [np.concatenate([template[:32], rng.randint(0, 1024, (n,))])
               for n in (5, 17, 30)] + [template]
    streams = []
    for uncaptured in (False, True):
        eng = ServingEngine(model, kv="paged", prefix_cache=True,
                            device=cuda, **ENGINE)
        eng._run_uncaptured = uncaptured
        eng.warmup()
        first = eng.submit(template, max_new_tokens=4)
        eng.run_until_drained(timeout=120)
        shared = _cached_blocks(eng)
        assert len(shared) == 3
        resps = [first] + [
            eng.submit(p, max_new_tokens=24,
                       **({"decode_strategy": "sampling", "seed": 4}
                          if i == 1 else {}))
            for i, p in enumerate(prompts)]
        eng.run_until_drained(timeout=300)
        after = _cached_blocks(eng)
        for b, tensors in shared.items():
            assert all(torch.equal(x, y) for x, y in zip(tensors, after[b]))
        stats = eng.prefix_cache.stats()
        assert stats["hits"] > 0 and stats["cow_copies"] == 1
        assert eng.post_warmup_compiles() == 0
        streams.append([r.tokens(timeout=5) for r in resps])
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# jit.TrainStep: step programs captured as CUDA graphs, with recompute
# ---------------------------------------------------------------------------
# Inside the port a captured step is the same kernels on the same inputs as
# the uncaptured one, and the generator is registered with the graph: the
# losses and parameters are compared bit for bit.

TRAIN_GPT = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=2, hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1,
                 max_position_embeddings=256)
STAGES = ("stages", "dots_saveable")


def _policy(spec_policy):
    from contextlib import nullcontext
    from paddle_tpu_torch.jit import recompute_policy
    return recompute_policy(*spec_policy) if spec_policy else nullcontext()


def _train_gpt(cuda, uncaptured=False, **kw):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTConfig, GPTForPretraining,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    pt.seed(0)
    model = GPTForPretraining(GPTConfig(**TRAIN_GPT), device=cuda, seed=5)
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                parameters=model.parameters())
    step = TrainStep(model, lambda lg, y: crit(lg, y), opt, **kw)
    step._run_uncaptured = uncaptured
    return model, step


def _train_resnet(cuda, uncaptured=False, **kw):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18
    pt.seed(0)
    model = resnet18(num_classes=10, device=cuda, seed=5)
    opt = Momentum(learning_rate=0.05, momentum=0.9,
                   parameters=model.parameters())
    step = TrainStep(model, lambda lg, y: F.cross_entropy(lg, y), opt,
                     amp_level="O2", **kw)
    step._run_uncaptured = uncaptured
    return model, step


def _train_batches(cuda, model, n=3, b=4):
    rng = np.random.RandomState(6)
    if model == "gpt":
        return [tuple(torch.from_numpy(rng.randint(0, 512, (b, 256)))
                      .to(cuda) for _ in range(2)) for _ in range(n)]
    return [(torch.from_numpy(rng.randn(b * 4, 3, 64, 64).astype(np.float32))
             .to(cuda), torch.from_numpy(rng.randint(0, 10, (b * 4,)))
             .to(cuda)) for _ in range(n)]


def _train_run(cuda, model, uncaptured, spec_policy=None, lrs=None):
    """Three steps: (losses, final state, launches per wrapper, the step)."""
    from paddle_tpu_torch.jit import layout_policy
    make = _train_gpt if model == "gpt" else _train_resnet
    batches = _train_batches(cuda, model)
    with _policy(spec_policy), layout_policy("NHWC"):
        m, step = make(cuda, uncaptured)
        step.warmup(*batches[0])
        base = _launch_counts()
        losses = []
        for i, b in enumerate(batches):
            if lrs:
                step.optimizer.set_lr(lrs[i])
            losses.append(step(*b))
        counts = {k: v - base[k] for k, v in _launch_counts().items()}
    torch.cuda.synchronize()
    return (torch.stack(losses),
            {k: v.clone() for k, v in m.state_dict().items()}, counts, step)


def _launch_counts():
    from paddle_tpu_torch.ops import flash_attention as fa
    return {w.__name__: w.launches for w in (
        fa.flash_fwd, fa.flash_bwd, fbn.bn_stats, fbn.bn_apply,
        fbn.bn_bwd_reduce, fbn.bn_bwd_dx, fbn.bn_pool_apply)}


def _assert_equal_states(a, b):
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("spec_policy", [None, STAGES],
                         ids=["plain", "stages"])
@pytest.mark.parametrize("model", ["gpt", "resnet"])
def test_train_step_captured_equals_uncaptured(cuda, model, spec_policy):
    """Three steps replayed from the step's CUDA graph and the same three
    run uncaptured from the same seed (GPT with dropout 0.1: the replays
    advance the registered generator as the eager steps do, and under
    recompute each region's twin generator redraws its masks): losses,
    parameters and running statistics bit-equal; one capture, none after
    warmup; launches through replays equal the eager launches."""
    got = _train_run(cuda, model, False, spec_policy)
    want = _train_run(cuda, model, True, spec_policy)
    assert torch.equal(got[0], want[0]), (got[0], want[0])
    _assert_equal_states(got[1], want[1])
    assert got[2] == want[2]
    assert got[3].compile_counts()["total"] == 1
    prog = next(iter(got[3]._programs.values()))
    assert prog.graph is not None
    assert next(iter(want[3]._programs.values())).graph is None
    if spec_policy and model == "gpt":   # recompute: bit-equal to none
        plain = _train_run(cuda, model, False)
        assert torch.equal(got[0], plain[0])
        _assert_equal_states(got[1], plain[1])


def test_train_step_replays_count_the_stated_launches(cuda):
    """Kernel launches per step through replays: K1 and K2 once per layer,
    K1 twice under "stages" (each block's region reruns its forward); the
    ResNet-18 step's K5-K9 as eager, and under "stages" K5 and K6 once
    more at every block site (the stem is in no block)."""
    layers = TRAIN_GPT["num_hidden_layers"]
    plain = _train_run(cuda, "gpt", False)[2]
    stages = _train_run(cuda, "gpt", False, STAGES)[2]
    assert plain["flash_fwd"] == plain["flash_bwd"] == 3 * layers
    assert stages["flash_fwd"] == 2 * 3 * layers
    assert stages["flash_bwd"] == 3 * layers
    eager = _train_run(cuda, "resnet", True)[2]
    r_plain = _train_run(cuda, "resnet", False)[2]
    r_stages = _train_run(cuda, "resnet", False, STAGES)[2]
    assert r_plain == eager
    # ResNet-18: 13 single and 3 dual block sites, the pooled stem
    assert eager["bn_stats"] == 3 * (13 + 2 * 3 + 1)
    assert eager["bn_pool_apply"] == 3
    assert r_stages == dict(eager, bn_stats=eager["bn_stats"] + 3 * 19,
                            bn_apply=eager["bn_apply"] + 3 * 16)


def test_train_step_follows_set_lr_between_replays(cuda):
    lrs = (1e-3, 4e-3, 2e-4)
    got = _train_run(cuda, "gpt", False, lrs=lrs)
    want = _train_run(cuda, "gpt", True, lrs=lrs)
    fixed = _train_run(cuda, "gpt", False)
    assert torch.equal(got[0], want[0])
    _assert_equal_states(got[1], want[1])
    assert not torch.equal(got[1]["gpt.ln_f.weight"],
                           fixed[1]["gpt.ln_f.weight"])


def test_train_step_warmup_moves_nothing_and_captures_once(cuda):
    """warmup() of a second signature after a real step: parameters,
    optimizer state and generator bit-equal before and after, the next
    steps equal a twin's that never warmed up, and no capture follows."""
    small, large = (_train_batches(cuda, "gpt", 1, b)[0] for b in (2, 4))
    runs = []
    for warm in (True, False):
        model, step = _train_gpt(cuda)
        step(*small)
        before = ({k: v.clone() for k, v in model.state_dict().items()},
                  [t.clone() for s in step._opt_state.values()
                   for t in s.values()], step._gen.get_state())
        if warm:
            assert step.warmup(*large)["compiled"]
            torch.cuda.synchronize()
            _assert_equal_states(before[0], model.state_dict())
            assert all(torch.equal(a, b) for a, b in zip(
                before[1], [t for s in step._opt_state.values()
                            for t in s.values()]))
            assert torch.equal(before[2], step._gen.get_state())
            assert step.compile_counts()["total"] == 2
        losses = [step(*b) for b in (large, small, large)]
        runs.append((torch.stack(losses), model.state_dict()))
        assert step.compile_counts()["total"] == 2
    assert torch.equal(runs[0][0], runs[1][0])
    _assert_equal_states(runs[0][1], runs[1][1])


def test_train_step_run_steps_replays(cuda):
    batches = _train_batches(cuda, "gpt")
    stacked = tuple(torch.stack(t) for t in zip(*batches))
    m1, s1 = _train_gpt(cuda)
    got = s1.run_steps(*stacked)
    m2, s2 = _train_gpt(cuda)
    want = torch.stack([s2(*b) for b in batches])
    assert torch.equal(got, want)
    _assert_equal_states(m1.state_dict(), m2.state_dict())
    assert s1.compile_counts()["total"] == 1


# ---------------------------------------------------------------------------
# speculative decoding: the verify tick's shapes, programs and weight swap
# ---------------------------------------------------------------------------
# GPT-2 medium's verify: 8 slots x (K + 1 = 5) rows flattened to 40 query
# rows of 16 heads, each with its slot's table and position pos + j; the
# draft (GPT-2 small's widths) runs K4 at M = 8 on 768 / 3072.

def _verify_case(rng, slots, k1, bs, h, d, pos):
    """A slot-level paged case, its query rows repeated K+1 times per slot
    (tables repeated per row, positions pos + j)."""
    nb = -(-(max(pos) + k1) // bs) + 1
    _, kp, vp, tables, _ = _paged_case(rng, slots, nb * slots, bs, h, d, nb,
                                       [p + k1 - 1 for p in pos])
    q = torch.from_numpy(rng.randn(slots * k1, h, d).astype(np.float32))
    rows = torch.repeat_interleave(tables, k1, dim=0)
    qpos = (torch.tensor(pos)[:, None] + torch.arange(k1)).reshape(-1)
    return q, kp, vp, rows, qpos.to(torch.int32)


@pytest.mark.parametrize("kv_dt", ["f32", "bf16"])
def test_paged_attention_at_the_verify_shape(cuda, kv_dt):
    rng = np.random.RandomState(11)
    q, kp, vp, tables, pos = [a.to(cuda) for a in _verify_case(
        rng, 8, 5, 16, 16, 64, [17, 100, 511, 600, 700, 1000, 0, 15])]
    kp, vp = kp.to(DTYPES[kv_dt]), vp.to(DTYPES[kv_dt])
    assert q.shape == (40, 16, 64)
    got = pa.paged_attention(q, kp, vp, tables, pos)
    again = pa.paged_attention(q, kp, vp, tables, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, pa._plain(q, kp, vp, tables, pos), **TOL)
    assert torch.equal(got, again)


@pytest.mark.parametrize("m,k,n", [
    (40, 1024, 3072), (40, 1024, 1024), (40, 1024, 4096), (40, 4096, 1024),
    (8, 768, 2304), (8, 768, 768), (8, 768, 3072), (8, 3072, 768)])
def test_int8_matmul_at_the_verify_and_draft_shapes(cuda, m, k, n):
    rng = np.random.RandomState(m + k + n)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(cuda)
    wi, s = quantize_weight_int8(
        torch.from_numpy((0.02 * rng.randn(k, n)).astype(np.float32)).to(cuda))
    got = int8_matmul.dequant_matmul(x, wi, s)
    again = int8_matmul.dequant_matmul(x, wi, s)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, int8_matmul._plain(x, wi, s), **TOL)
    assert torch.equal(got, again)


SPEC_ENGINE = dict(ENGINE, spec_tokens=3)


@pytest.mark.parametrize("kv", ["fixed", "paged"])
def test_spec_engine_captured_streams_equal_uncaptured(cuda, kv):
    """A speculative engine (a 1-layer draft) with greedy, sampled and
    spec-off traffic: the captured engine's streams equal the uncaptured
    path's, warmup captures len(buckets) + 2 graphs and nothing after;
    a verify replay launches K4 4 times per target layer and (K+1) x 4 per
    draft layer, and (paged) K3 once per target layer and K+1 times per
    draft layer."""
    from paddle_tpu_torch.serving import ServingEngine
    model = _serving_model(cuda, torch.float32)
    draft = _serving_model(cuda, torch.float32, seed=5, layers=1)
    streams = []
    for uncaptured in (False, True):
        eng = ServingEngine(model, kv=kv, draft_model=draft, device=cuda,
                            **SPEC_ENGINE)
        eng._run_uncaptured = uncaptured
        report = eng.warmup()
        assert report["compile_counts"]["total"] == len(
            ENGINE["prefill_buckets"]) + 2
        k1 = SPEC_ENGINE["spec_tokens"] + 1
        for name in ("decode", "decode_greedy"):
            want = {"dequant_matmul": 4 * (2 + k1)}
            if kv == "paged":
                want["paged_attention"] = 2 + k1
            assert _per_replay(eng._programs[name]) == want
        resps = _traffic(eng, 6)
        resps.append(eng.submit([5, 6, 7], max_new_tokens=20, spec=False,
                                decode_strategy="sampling", seed=9))
        eng.run_until_drained(timeout=300)
        streams.append([r.tokens(timeout=5) for r in resps])
        assert eng.post_warmup_compiles() == 0
        assert eng.metrics()["spec"]["ticks"] > 0
    assert streams[0] == streams[1]


def test_spec_verify_logits_match_the_plain_path_on_the_cpu(cuda):
    """One verify tick's target logits (8 slots' K+1 rows) on the kernel
    path against the same tick by the plain versions on the CPU, on the
    same paged KV state: within the logit tolerance."""
    import copy

    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.engine import paged_decode_logits
    model = _serving_model(cuda, torch.float32)
    draft = _serving_model(cuda, torch.float32, seed=5, layers=1)
    eng = ServingEngine(model, kv="paged", draft_model=draft, device=cuda,
                        **SPEC_ENGINE)
    eng.warmup()
    _traffic(eng, 4)
    eng.step()
    eng.step()
    eng._ensure_decode_blocks()
    tables = eng._host_tables()
    active = np.zeros(ENGINE["max_slots"], bool)
    pos = np.zeros(ENGINE["max_slots"], np.int64)
    for slot, run in eng._slots.items():
        active[slot], pos[slot] = True, run.pos
    ids = torch.from_numpy(np.random.RandomState(2).randint(
        0, 1024, (ENGINE["max_slots"], SPEC_ENGINE["spec_tokens"] + 1)))
    geo = (eng.kv_pool.num_blocks, ENGINE["block_size"], eng._pool_len)
    with torch.inference_mode():
        pools = [(k.clone(), v.clone()) for k, v in eng._pools]
        kern = paged_decode_logits(model, pools, tables,
                                   torch.from_numpy(tables).to(cuda), active,
                                   pos, ids.to(cuda), *geo).cpu()
        plain = paged_decode_logits(
            copy.deepcopy(model).cpu(),
            [(k.cpu(), v.cpu()) for k, v in eng._pools], tables,
            torch.from_numpy(tables), active, pos, ids, *geo)
    live = torch.from_numpy(active)
    assert float((kern[live] - plain[live]).abs().max()) <= LOGIT_TOL


def test_swap_weights_on_a_captured_engine(cuda):
    """A captured engine swapped to another draw of the weights serves
    the new weights (streams equal a fresh captured engine's on them),
    in place in its own copy of the model, with nothing captured again."""
    from paddle_tpu_torch.serving import ServingEngine
    model = _serving_model(cuda, torch.float32)
    new = _serving_model(cuda, torch.float32, seed=4)
    eng = ServingEngine(model, kv="paged", device=cuda, **ENGINE)
    eng.warmup()
    _traffic(eng)
    eng.run_until_drained(timeout=300)
    served = eng.model.state_dict()
    ptrs = [t.data_ptr() for t in served.values()]
    eng.swap_weights({k: t.clone() for k, t in new.state_dict().items()})
    assert [t.data_ptr() for t in served.values()] == ptrs
    for k, t in new.state_dict().items():
        assert torch.equal(served[k], t), k
    got = [r for r in _traffic(eng)]
    eng.run_until_drained(timeout=300)
    fresh = ServingEngine(new, kv="paged", device=cuda, **ENGINE)
    fresh.warmup()
    want = _traffic(fresh)
    fresh.run_until_drained(timeout=300)
    assert [r.tokens(timeout=5) for r in got] == \
        [r.tokens(timeout=5) for r in want]
    assert eng.post_warmup_compiles() == 0


def _greedy(eng, prompts, n=24):
    resps = [eng.submit(p, max_new_tokens=n) for p in prompts]
    eng.run_until_drained(timeout=300)
    return [r.tokens(timeout=5) for r in resps]


FLEET_PROMPTS = [np.random.RandomState(i).randint(0, 1024, (n,))
                 for i, n in enumerate((5, 17, 33, 9, 50, 12, 40, 3))]


def test_swap_on_a_captured_engine_leaves_its_peer_and_the_model(cuda):
    """Two captured engines over one model: a swap on one leaves the
    other's streams, and the model's tensors, unchanged; nothing is
    captured on either."""
    from paddle_tpu_torch.serving import ServingEngine
    model = _serving_model(cuda, torch.float32)
    new = _serving_model(cuda, torch.float32, seed=4)
    kept = {k: t.clone() for k, t in model.state_dict().items()}
    a, b = (ServingEngine(model, kv="paged", device=cuda, **ENGINE)
            for _ in range(2))
    a.warmup()
    b.warmup()
    before = _greedy(b, FLEET_PROMPTS[:4])
    a.swap_weights({k: t.clone() for k, t in new.state_dict().items()})
    assert _greedy(b, FLEET_PROMPTS[:4]) == before
    for k, t in model.state_dict().items():
        assert torch.equal(t, kept[k]), k
    fresh = ServingEngine(new, kv="paged", device=cuda, **ENGINE)
    fresh.warmup()
    assert _greedy(a, FLEET_PROMPTS[:4]) == _greedy(fresh, FLEET_PROMPTS[:4])
    assert a.post_warmup_compiles() == b.post_warmup_compiles() == 0


def test_captured_fleet_failover_and_migration_streams(cuda):
    """A captured two-replica fleet over one model: greedy streams
    resubmitted off a crashed replica, and streams migrated mid-decode off
    a drained one, equal an uninterrupted engine's with the same options;
    the crash count is the one injected."""
    from paddle_tpu_torch.serving import FleetRouter, ServingEngine
    from paddle_tpu_torch.utils import faults
    model = _serving_model(cuda, torch.float32)

    def make():
        return ServingEngine(model, kv="paged", device=cuda, **ENGINE)

    solo = make()
    solo.warmup()
    want = _greedy(solo, FLEET_PROMPTS)
    fleet = FleetRouter([make(), make()])
    fleet.warmup()
    try:
        resps = [fleet.submit(p, 24, resubmit=True) for p in FLEET_PROMPTS]
        for _ in range(3):
            fleet.step()
        faults.enable("replica_crash", f"1:{fleet.manager.get(1).steps}")
        fleet.run_until_drained(timeout=300)
        faults.reset()
        assert [r.tokens(timeout=5) for r in resps] == want
        c = fleet.manager.counters()
        assert c["failovers"] == 1 and c["resubmits"] >= 1
        assert c["lost"] == 0
        fleet.add_replica(make())
        fleet.warmup()
        pinned = [fleet.submit(p, 24, session="pin")
                  for p in FLEET_PROMPTS[:4]]
        for _ in range(3):
            fleet.step()
        (rid,) = {r.id for r in fleet.manager.replicas(("healthy",))
                  if r.engine.scheduler.occupancy()}
        fleet.drain(rid)
        fleet.run_until_drained(timeout=300)
        assert [r.tokens(timeout=5) for r in pinned] == want[:4]
        assert all(r.request.migrations == 1 for r in pinned)
        assert fleet.manager.counters()["failovers"] == 1
        assert fleet.post_warmup_compiles() == 0
    finally:
        faults.reset()
        fleet.close()


def test_a_replica_boots_while_another_replays(cuda):
    """The fleet's loop replays one replica's graphs while this thread
    captures a second replica's: no error, no request dropped, no crash,
    every stream equal to an uninterrupted engine's."""
    import threading

    from paddle_tpu_torch.serving import FleetRouter, ServingEngine
    model = _serving_model(cuda, torch.float32)

    def make():
        return ServingEngine(model, kv="paged", device=cuda, **ENGINE)

    solo = make()
    solo.warmup()
    want = _greedy(solo, FLEET_PROMPTS, n=64)
    fleet = FleetRouter([make()])
    fleet.warmup()
    resps = []

    def submitter():
        for p in FLEET_PROMPTS:
            resps.append(fleet.submit(p, 64))
            threading.Event().wait(0.02)

    t = threading.Thread(target=submitter)
    try:
        fleet.start()
        t.start()
        while not fleet.manager.replicas()[0].engine.scheduler.occupancy():
            threading.Event().wait(0.001)
        eng = make()
        assert eng.warmup()["captured"]
        fleet.add_replica(eng)
        fleet.warmup()
        t.join(timeout=60)
        assert not t.is_alive()
        assert [r.tokens(timeout=300) for r in resps] == want
        assert fleet.manager.counters()["failovers"] == 0
        assert fleet.post_warmup_compiles() == 0
    finally:
        fleet.close()
        t.join(timeout=5)


def test_remove_returns_the_card_memory(cuda):
    """A replica added, warmed, serving, drained and removed leaves the
    card's allocated memory within 1 MiB of where it was before it was
    built (its weights copy, KV pools and graph pool freed)."""
    import gc

    from paddle_tpu_torch.serving import FleetRouter, ServingEngine
    model = _serving_model(cuda, torch.float32)

    def make():
        eng = ServingEngine(model, kv="paged", device=cuda, **ENGINE)
        eng.warmup()
        return eng

    fleet = FleetRouter([make()])
    try:
        _greedy(fleet.manager.replicas()[0].engine, FLEET_PROMPTS[:2])
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        rid = fleet.add_replica(make())
        grown = torch.cuda.memory_allocated() - before
        resps = [fleet.submit(p, 24) for p in FLEET_PROMPTS]
        fleet.run_until_drained(timeout=300)
        assert all(r.error is None for r in resps)
        fleet.drain(rid)
        fleet.step()         # an idle draining replica closes at a tick
        fleet.remove(rid)
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated() - before
        assert grown > 0 and left <= 1 << 20, (grown, left)
    finally:
        fleet.close()


def _lora_artifacts(model, tmp_path, n, rank=4):
    """``n`` adapters of ``model`` made by ``apply_lora`` + ``export_adapter``
    on a copy, with random nonzero factors."""
    import copy

    from paddle_tpu_torch import lora
    paths = []
    for i in range(n):
        wrapped = copy.deepcopy(model)
        lora.apply_lora(wrapped, rank=rank)
        gen = torch.Generator(device=model.device).manual_seed(10 + i)
        with torch.no_grad():
            for m in wrapped.modules():
                if isinstance(m, lora.LoRALinear):
                    m.lora_A.normal_(0.0, 0.05, generator=gen)
                    m.lora_B.normal_(0.0, 0.05, generator=gen)
        paths.append(str(tmp_path / f"adapter{i}.npz"))
        lora.export_adapter(wrapped, paths[-1])
        del wrapped
    return paths


@pytest.mark.parametrize("kv", ["fixed", "paged"])
def test_lora_engine_captured_streams_equal_uncaptured(cuda, kv, tmp_path):
    """A LoRA engine's replays (mixed adapters per slot, greedy and
    sampled) against its uncaptured run: equal streams, K3 / K4 launches
    through the replays, and a hot load after warmup captures nothing."""
    import copy

    from paddle_tpu_torch.lora import LoRAConfig
    from paddle_tpu_torch.serving import ServingEngine
    model = _serving_model(cuda, torch.float32)
    paths = _lora_artifacts(model, tmp_path, 4)
    streams = []
    for uncaptured in (False, True):
        eng = ServingEngine(copy.deepcopy(model), kv=kv, device=cuda,
                            lora=LoRAConfig(rank=4, max_adapters=3),
                            **ENGINE)
        eng._run_uncaptured = uncaptured
        assert eng.warmup()["compile_counts"]["total"] == len(
            ENGINE["prefill_buckets"]) + 2
        for i in range(3):
            eng.load_adapter(f"a{i}", paths[i])
        pa.paged_attention.launches = int8_matmul.dequant_matmul.launches = 0
        rng = np.random.RandomState(4)
        resps = [eng.submit(rng.randint(0, 1024, (int(rng.randint(3, 60)),)),
                            max_new_tokens=24,
                            adapter=None if i % 4 == 3 else f"a{i % 4}",
                            **({"decode_strategy": "sampling", "seed": i,
                                "top_k": 50} if i % 3 == 2 else {}))
                 for i in range(8)]
        eng.run_until_drained(timeout=300)
        if kv == "paged":
            assert pa.paged_attention.launches > 0
        assert int8_matmul.dequant_matmul.launches > 0
        eng.load_adapter("a3", paths[3])        # hot: evicts an idle row
        late = eng.submit([5, 6, 7], max_new_tokens=8, adapter="a3")
        eng.run_until_drained(timeout=60)
        streams.append([r.tokens(timeout=5) for r in resps + [late]])
        assert eng.post_warmup_compiles() == 0
        del eng
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# BERT / ERNIE: K1 / K2 non-causal with the padding bias, the captured step
# under a learning-rate schedule, and a checkpoint resume into a captured
# step
# ---------------------------------------------------------------------------

def _padding_bias(cuda, b, s, seed):
    """BERT's (B, Sk) padding bias: 0 on a row's real keys, -1e4 past its
    length (lengths drawn from 128..s)."""
    lens = np.random.RandomState(seed).randint(128, s + 1, (b,))
    keys = np.arange(s)[None, :]
    return torch.from_numpy(np.where(keys < lens[:, None], 0.0, -1e4)
                            .astype(np.float32)).to(cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_bert_shape_match_plain(cuda, dtype):
    """B 2, S 512, H 4, D 64, non-causal, the padding bias, dropout 0.1:
    every output and gradient (dbias too) against the plain versions."""
    from paddle_tpu_torch.ops import flash_attention as fa
    b, s, h, d, p = 2, 512, 4, 64, 0.1
    q, k, v, do, _, _, _ = _flash_case(cuda, b, s, s, h, d, dtype, seed=8)
    bi = _padding_bias(cuda, b, s, 8)
    seed = torch.tensor([2718], dtype=torch.int32, device=cuda)
    args = (q, k, v, bi, None, None, seed, False, p)
    f0, b0 = fa.flash_fwd.launches, fa.flash_bwd.launches
    o, lse = fa.flash_fwd(*args)
    grads = fa.flash_bwd(q, k, v, bi, None, None, seed, o, lse, do, False, p)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == (f0 + 1, b0 + 1)
    po, plse = fa._plain_fwd(*args)
    pgrads = fa._plain_bwd(q, k, v, bi, None, None, seed, o, lse, do, False,
                           p)
    tol_o, tol_g = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), po.float(), **tol_o)
    torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-4)
    for g, pg in zip(grads, pgrads):
        assert g.dtype == pg.dtype and g.shape == pg.shape
        torch.testing.assert_close(g.float(), pg.float(), **tol_g)


TRAIN_BERT = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                  num_attention_heads=2, intermediate_size=256,
                  max_position_embeddings=256, hidden_dropout_prob=0.1,
                  attention_probs_dropout_prob=0.1)


def _bert_batch(cuda, seed=12, b=4, s=256):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 512, (b, s))
    lens = rng.randint(128, s + 1, (b,))
    mask = (np.arange(s)[None] < lens[:, None]).astype(np.int64)
    tt = (np.arange(s)[None] >= lens[:, None] // 2).astype(np.int64)
    pos = np.broadcast_to(np.arange(s), (b, s))
    lab = np.where((rng.rand(b, s) < 0.15) & (mask > 0), ids, -100)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                 for a in (ids, tt, pos, mask, lab))


def _bert_step(cuda, uncaptured=False):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         BertPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW, lr
    pt.seed(0)
    model = BertForPretraining(BertConfig(**TRAIN_BERT), device=cuda, seed=5)
    crit = BertPretrainingCriterion()
    sched = lr.LinearWarmup(lr.PolynomialDecay(2e-3, decay_steps=4),
                            warmup_steps=2, start_lr=1e-4, end_lr=2e-3)
    opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                apply_decay_param_fun=lambda n: "bias" not in n
                and "norm" not in n)
    step = TrainStep(model, lambda lg, nsp, y: crit(lg, nsp, y), opt,
                     amp_level="O1")
    step._run_uncaptured = uncaptured
    return model, sched, step


def test_bert_train_step_captured_equals_uncaptured_under_a_schedule(cuda):
    """Five O1 steps with dropout and the padding bias under a warmup +
    decay schedule: captured == uncaptured bit for bit, one capture, K1 and
    K2 once per layer per step through the replays."""
    from paddle_tpu_torch.ops import flash_attention as fa
    batch = _bert_batch(cuda)
    runs = []
    for uncaptured in (False, True):
        model, sched, step = _bert_step(cuda, uncaptured)
        step.warmup(*batch)
        f0, b0 = fa.flash_fwd.launches, fa.flash_bwd.launches
        losses = []
        for _ in range(5):
            losses.append(step(*batch))
            sched.step()
        torch.cuda.synchronize()
        layers = TRAIN_BERT["num_hidden_layers"]
        assert fa.flash_fwd.launches - f0 == 5 * layers
        assert fa.flash_bwd.launches - b0 == 5 * layers
        assert step.compile_counts()["total"] == 1
        runs.append((torch.stack(losses),
                     {k: v.clone() for k, v in model.state_dict().items()}))
    assert torch.equal(runs[0][0], runs[1][0])
    _assert_equal_states(runs[0][1], runs[1][1])


def test_bert_checkpoint_resumes_into_a_captured_step(cuda, tmp_path):
    """Save after step 2; a fresh captured step that already ran restores
    in place (no new capture) and its steps 3-5 equal the uninterrupted
    run's bit for bit, dropout and schedule included."""
    batch = _bert_batch(cuda, seed=13)
    model, sched, step = _bert_step(cuda)
    full = []
    for i in range(5):
        full.append(step(*batch))
        sched.step()
        if i == 1:
            step.save_checkpoint(str(tmp_path))
    model2, sched2, step2 = _bert_step(cuda)
    step2(*batch)
    made = step2.compile_counts()["total"]
    assert step2.restore_checkpoint(str(tmp_path))["step"] == 2
    got = []
    for _ in range(3):
        got.append(step2(*batch))
        sched2.step()
    assert torch.equal(torch.stack(got), torch.stack(full[2:]))
    assert step2.compile_counts()["total"] == made
    _assert_equal_states(model.state_dict(), model2.state_dict())


# ---------------------------------------------------------------------------
# telemetry, beam search and the nan_grads guard on the card
# ---------------------------------------------------------------------------

def test_engine_profile_keeps_launches_and_captures(cuda):
    """The captured engine serving the same traffic with profile=False,
    then True: equal greedy streams and K3 / K4 launch counts, one span
    per admission and per decode step, the TTFT histogram one count per
    request, nothing captured after warmup."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import ServingEngine
    eng = ServingEngine(_serving_model(cuda, torch.float32), kv="paged",
                        device=cuda, **ENGINE)
    eng.warmup()
    runs = []
    for profile in (False, True):
        eng._profile = profile
        obs.get_tracer().clear()
        h0 = obs.get_registry().get("serving_ttft_seconds").snapshot()
        int8_matmul.dequant_matmul.launches = 0
        pa.paged_attention.launches = 0
        resps = _traffic(eng, 6)
        eng.run_until_drained(timeout=300)
        toks = [r.tokens(timeout=5) for r in resps]
        h1 = obs.get_registry().get("serving_ttft_seconds").snapshot()
        assert h1["count"] - h0["count"] == len(resps)
        spans = {k: v[0] for k, v in obs.get_tracer().aggregates().items()}
        if profile:
            assert spans["serving_prefill"] == len(resps)
            assert spans["serving_decode"] > 0
        else:
            assert not any(k.startswith("serving_") for k in spans)
        runs.append(([t for i, t in enumerate(toks) if i % 2 == 0],
                     int8_matmul.dequant_matmul.launches,
                     pa.paged_attention.launches))
    assert runs[0] == runs[1]
    assert eng.post_warmup_compiles() == 0
    for name in ("serving_decode", "serving_decode_greedy"):
        rec = obs.get_program_registry().get(name)
        assert rec["compiles"] >= 1 and rec["meta"] == {"captured": True}
        assert rec["compile_seconds_total"] > 0
    # the traffic samples: every step replays the mixed graph
    assert obs.get_program_registry().get("serving_decode")["replays"] > 0


def test_beam_search_on_the_card_equals_the_cpu(cuda):
    """Beam search of the int8 serving model (K4 and SDPA on the card)
    against its copy on the CPU (the plain versions): equal beams, scores
    within 1e-4 of each other; num_beams=1 equals greedy."""
    import copy
    from paddle_tpu_torch.generation import generate
    model = _serving_model(cuda, torch.float32)
    ids = torch.from_numpy(np.random.RandomState(2).randint(
        0, 1024, (2, 12))).to(cuda)
    kw = dict(max_new_tokens=10, decode_strategy="beam_search", num_beams=4)
    out, sc = generate(model, ids, device=cuda, **kw)
    cpu = copy.deepcopy(model).cpu()
    want, wsc = generate(cpu, ids.cpu(), device="cpu", **kw)
    assert torch.equal(out.cpu(), want)
    torch.testing.assert_close(sc.cpu(), wsc, rtol=1e-4, atol=1e-4)
    one, _ = generate(model, ids, device=cuda, max_new_tokens=10,
                      decode_strategy="beam_search", num_beams=1)
    greedy, _ = generate(model, ids, device=cuda, max_new_tokens=10)
    assert torch.equal(one, greedy)


def test_train_step_nan_grads_skips_the_step_in_the_graph(cuda):
    """PDTPU_FAULT_NAN_GRADS="2" armed at the capture: the captured guarded
    step skips step 2 with the parameters and moments bit-equal, replays
    the other steps, and captures nothing more."""
    from paddle_tpu_torch.utils import faults
    model, step = _train_gpt(cuda, guard=True)
    batch = _train_batches(cuda, "gpt", n=1)[0]
    faults.enable("nan_grads", "2")
    try:
        step.warmup(*batch)
    finally:
        faults.disable("nan_grads")
    made = step.compile_counts()["total"]
    oks = []
    for i in range(3):
        before = [t.clone() for t in step._state_tensors()[:-2]]
        step(*batch)
        oks.append(bool(step.last_guard[1]))
        same = all(torch.equal(a, b)
                   for a, b in zip(before, step._state_tensors()[:-2]))
        assert same == (i == 1)
    assert oks == [True, False, True]
    assert step.compile_counts()["total"] == made


# ---------------------------------------------------------------------------
# the kernels as operators: torch.export, fake implementations, CUDA graphs
# ---------------------------------------------------------------------------

def _export_module(cuda):
    """An int8 Linear (K4) feeding flash attention (K1), as one module."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.quantization import quantize_for_serving

    class Block(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.qkv = tnn.Linear(128, 384, device=cuda, std=0.05)

        def forward(self, x, mask):
            b, s = x.shape[0], x.shape[1]
            qkv = self.qkv(x).reshape(b, s, 3, 2, 64)
            bias = (1.0 - mask.to(torch.float32)) * -1e4
            return fa.flash_attention_bshd(qkv[:, :, 0], qkv[:, :, 1],
                                           qkv[:, :, 2], bias=bias)

    torch.manual_seed(0)
    return quantize_for_serving(Block().eval())


def test_exported_program_launches_the_kernels_and_equals_eager(cuda,
                                                                 tmp_path):
    """jit.save exports K1 and K4 as one operator node each; the loaded
    program launches both kernels (the counters rise) and equals the eager
    kernel path."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.ops import flash_attention as fa
    m = _export_module(cuda)
    path = str(tmp_path / "block")
    jit.save(m, path, input_spec=[jit.InputSpec([-1, 128, 128], "float32"),
                                  jit.InputSpec([-1, 128], "int64")])
    layer = jit.load(path, device=cuda)
    targets = [str(n.target) for n in layer._exported.graph.nodes]
    assert sum("flash_fwd" in t for t in targets) == 1
    assert sum("dequant_matmul" in t for t in targets) == 1
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(3, 128, 128).astype(np.float32)).to(cuda)
    mask = torch.ones(3, 128, dtype=torch.int64, device=cuda)
    mask[1, 70:] = 0
    k1, k4 = fa.flash_fwd.launches, int8_matmul.dequant_matmul.launches
    got = layer(x, mask)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == k1 + 1
    assert int8_matmul.dequant_matmul.launches == k4 + 1
    with torch.no_grad():
        want = m(x, mask)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operator_fakes_give_the_real_shapes_and_dtypes(cuda, dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from paddle_tpu_torch.ops import flash_attention as fa
    rng = np.random.RandomState(5)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            cuda, dtype)

    wi, s = quantize_weight_int8(torch.from_numpy(
        (0.02 * rng.randn(256, 384)).astype(np.float32)).to(cuda))
    seed = torch.zeros(1, dtype=torch.int32, device=cuda)
    bias = torch.zeros(2, 128, device=cuda)
    calls = [(torch.ops.paddle_tpu_torch.dequant_matmul.default,
              (t(8, 256), wi, s)),
             (torch.ops.paddle_tpu_torch.dequant_matmul.default,
              (t(300, 256), wi, s)),
             (torch.ops.paddle_tpu_torch.flash_fwd.default,
              (t(2, 128, 2, 64), t(2, 128, 2, 64), t(2, 128, 2, 64), bias,
               None, None, seed, False, 0.0)),
             (torch.ops.paddle_tpu_torch.flash_fwd.default,
              (t(2, 256, 2, 64), t(2, 256, 2, 64), t(2, 256, 2, 64), None,
               None, None, seed, True, 0.0))]
    for op, args in calls:
        real = op(*args)
        with FakeTensorMode(allow_non_fake_inputs=False) as mode:
            fake = op(*[mode.from_tensor(a) if isinstance(a, torch.Tensor)
                        else a for a in args])
        real = real if isinstance(real, tuple) else (real,)
        fake = fake if isinstance(fake, tuple) else (fake,)
        for r, f in zip(real, fake):
            assert (r.shape, r.dtype, r.device) == (f.shape, f.dtype,
                                                    f.device)


def test_cuda_graph_over_the_operators_replays_them(cuda):
    """A graph captured over K4 and K1's operators replays the kernels on
    new input values; the launches count once, at the capture."""
    from paddle_tpu_torch.ops import flash_attention as fa
    rng = np.random.RandomState(9)
    x = torch.zeros(8, 1024, device=cuda)
    q = torch.zeros(1, 128, 2, 64, device=cuda)
    wi, s = quantize_weight_int8(torch.from_numpy(
        (0.02 * rng.randn(1024, 256)).astype(np.float32)).to(cuda))

    def run():
        return (int8_matmul.dequant_matmul(x, wi, s),
                fa.flash_attention_bshd(q, q, q, causal=True))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    k1, k4 = fa.flash_fwd.launches, int8_matmul.dequant_matmul.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    assert (fa.flash_fwd.launches, int8_matmul.dequant_matmul.launches) == (
        k1 + 1, k4 + 1)
    for seed in (1, 2):
        r = np.random.RandomState(seed)
        x.copy_(torch.from_numpy(r.randn(8, 1024).astype(np.float32)))
        q.copy_(torch.from_numpy(r.randn(1, 128, 2, 64).astype(np.float32)))
        graph.replay()
        torch.cuda.synchronize()
        want = run()
        for g, w in zip(outs, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def _worker_model(seed=3, device=None):
    """The worker test's model factory (``test_torch_kernels_cuda:
    _worker_model``, imported by each worker process): ``_serving_model``'s
    GPT drawn by ``build_gpt`` on the CPU, so every process holds the same
    weights, then int8."""
    from paddle_tpu_torch.quantization import quantize_for_serving
    from paddle_tpu_torch.serving.worker import build_gpt
    return quantize_for_serving(build_gpt(
        seed, device=device, vocab_size=1024, hidden_size=256,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=256, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, initializer_range=0.2))


def test_two_worker_processes_launch_the_kernels_and_equal_in_process(
        cuda, monkeypatch):
    """Two ``python -m paddle_tpu_torch.serving.worker`` processes, each
    with its own CUDA context, capture their graphs and serve: each
    worker's K3 / K4 launches (read from the worker) are > 0, it captures
    nothing after warmup, and its greedy streams equal an in-process
    engine's over the same weights."""
    import os
    from paddle_tpu_torch.serving import FleetRouter, ServingEngine
    here = os.path.dirname(os.path.abspath(__file__))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p))
    solo = ServingEngine(_worker_model(device=cuda), kv="paged",
                         device=cuda, **ENGINE)
    solo.warmup()
    want = _greedy(solo, FLEET_PROMPTS)
    spec = {"model": {"factory": "test_torch_kernels_cuda:_worker_model",
                      "kwargs": {"seed": 3}},
            "engine": dict(ENGINE, kv="paged", device=str(cuda),
                           prefill_buckets=list(ENGINE["prefill_buckets"]))}
    fleet = FleetRouter([], heartbeat_timeout_s=60.0)
    try:
        ids = [fleet.add_worker(spec, boot_timeout_s=300) for _ in range(2)]
        fleet.warmup()
        halves = (FLEET_PROMPTS[:4], FLEET_PROMPTS[4:])
        for rid, prompts, expect in zip(ids, halves, (want[:4], want[4:])):
            client = fleet.manager.get(rid).engine
            before = client.metrics(fresh=True)["process"]["launches"]
            resps = []
            for p in prompts:
                req, resp = client.make_request(p, 24)
                client.scheduler.submit(req, resp)
                resps.append(resp)
            fleet.run_until_drained(timeout=300)
            assert [r.tokens(timeout=5) for r in resps] == expect
            m = client.metrics(fresh=True)
            after = m["process"]["launches"]
            for k in ("paged_attention", "dequant_matmul"):
                assert after[k] > before[k], (rid, k)
            assert m["post_warmup_compiles"] == 0
            assert m["process"]["modules"] == {"jax": False,
                                               "paddle_tpu": False}
        assert len({fleet.manager.get(r).engine.pid for r in ids}) == 2
    finally:
        fleet.close()


def test_a_set_saved_on_the_card_boots_a_worker_without_nvcc(
        cuda, monkeypatch, tmp_path):
    """A program set saved from a captured engine carries the kernel
    libraries its graphs launch; a worker booted from it under an empty
    program store installs them and builds nothing (store and build misses
    0, read from the worker), and its greedy streams equal the saving
    engine's."""
    import os
    from paddle_tpu_torch.programs import read_manifest
    from paddle_tpu_torch.serving import FleetRouter, ServingEngine
    here = os.path.dirname(os.path.abspath(__file__))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p))
    solo = ServingEngine(_worker_model(device=cuda), kv="paged",
                         device=cuda, **ENGINE)
    solo.warmup()
    path = solo.save_program_set(str(tmp_path / "tiny"))
    libs = read_manifest(path)["libraries"]
    assert {"paged_attention", "int8_matmul"} <= set(libs)
    want = _greedy(solo, FLEET_PROMPTS[:4])
    monkeypatch.setenv("PDTPU_PROGRAM_CACHE_DIR", str(tmp_path / "store"))
    spec = {"model": {"factory": "test_torch_kernels_cuda:_worker_model",
                      "kwargs": {"seed": 3}},
            "engine": dict(ENGINE, kv="paged", device=str(cuda),
                           prefill_buckets=list(ENGINE["prefill_buckets"])),
            "program_set": path}
    fleet = FleetRouter([], heartbeat_timeout_s=60.0)
    try:
        rid = fleet.add_worker(spec, boot_timeout_s=300)
        fleet.warmup()
        client = fleet.manager.get(rid).engine
        resps = []
        for p in FLEET_PROMPTS[:4]:
            req, resp = client.make_request(p, 24)
            client.scheduler.submit(req, resp)
            resps.append(resp)
        fleet.run_until_drained(timeout=300)
        assert [r.tokens(timeout=5) for r in resps] == want
        proc = client.metrics(fresh=True)["process"]
        assert proc["kernel_builds"]["misses"] == 0
        assert proc["kernel_builds"]["installs"] == len(libs)
        assert proc["program_store"]["misses"] == 0
        assert proc["program_store"]["dir"].startswith(str(tmp_path))
        assert set(proc["program_set"]["kinds"].values()) == {"recaptured"}
    finally:
        fleet.close()
        solo.close()


# ---------------------------------------------------------------------------
# row-sparse gradients, exported training programs (DLRM, TrainSession)
# ---------------------------------------------------------------------------

def test_merge_rows_and_lazy_update_captured_equal_eager(cuda):
    """merge_rows and the in-place lazy row update recorded in a CUDA
    graph (no host read in either) and replayed: equal to the eager calls
    on the same inputs; rows no lookup touched bit-equal.  index_add_
    sums a row's duplicates by atomics in any order, and the hottest row
    of a zipf draw repeats about a hundred times: the merged sums, and the
    rows and moments they move, within 1e-5."""
    from paddle_tpu_torch.core.selected_rows import RowSparseGrad
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.optimizer.sparse import lazy_row_update_, merge_rows
    rng = np.random.RandomState(3)
    height, width, n = 5000, 16, 512
    rows = torch.from_numpy((rng.zipf(1.3, n) - 1) % height).to(cuda)
    vals = torch.from_numpy(rng.randn(n, width).astype(np.float32)).to(cuda)
    w0 = torch.from_numpy(rng.randn(height, width).astype(np.float32))
    opt = Adam(1e-2)

    def run(captured):
        p = w0.to(cuda)
        state = opt.init_state(p)
        lr = torch.full((), 1e-2, device=cuda)
        step = torch.full((), 1, dtype=torch.int32, device=cuda)
        grad = RowSparseGrad(rows, vals, p.shape)

        def fn():
            lazy_row_update_(opt, p, grad, state, lr, step)
            return merge_rows(rows, vals, height)
        if not captured:
            return fn(), p, state
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()                        # warm run (a real update)
        torch.cuda.current_stream().wait_stream(side)
        p.copy_(w0.to(cuda))
        for t in state.values():
            t.zero_()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        p.copy_(w0.to(cuda))
        for t in state.values():
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        return out, p, state
    (ue, se), pe, ste = run(False)
    (uc, sc), pc, stc = run(True)
    assert torch.equal(ue, uc)
    torch.testing.assert_close(sc, se, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(pc, pe, rtol=1e-5, atol=1e-5)
    for k in ste:
        torch.testing.assert_close(stc[k], ste[k], rtol=1e-5, atol=1e-5)
    touched = torch.zeros(height, dtype=torch.bool, device=cuda)
    touched[rows] = True
    assert torch.equal(pc[~touched], w0.to(cuda)[~touched])
    assert bool((pc[touched] != w0.to(cuda)[touched]).any(1).all())


def _dlrm_step(cuda, uncaptured):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (DLRM, DLRMConfig, DLRMCriterion)
    cfg = DLRMConfig(dense_dim=13, vocab_sizes=(1000, 20, 30000, 7),
                     embedding_dim=16, bottom_mlp=(64,), top_mlp=(64,))
    model = DLRM(cfg, device=cuda, seed=2)
    step = TrainStep(model, DLRMCriterion(), pt.optimizer.Adam(
        1e-2, parameters=model.parameters()))
    step._run_uncaptured = uncaptured
    rng = np.random.RandomState(4)
    losses = []
    for _ in range(3):
        b = (torch.from_numpy(rng.randn(32, 13).astype(np.float32)),
             torch.from_numpy(np.stack([(rng.zipf(1.2, 32) - 1) % v
                                        for v in cfg.vocab_sizes], 1)),
             torch.from_numpy((rng.rand(32, 1) < 0.25).astype(np.float32)))
        losses.append(float(step(*(t.to(cuda) for t in b))))
    return losses, {k: v.clone() for k, v in model.state_dict().items()}, \
        step


def test_sparse_train_step_captured_equals_uncaptured(cuda):
    """A sparse DLRM TrainStep (the lookups' zero leaves and the lazy row
    update inside the step program) replayed from its CUDA graph against
    the same steps uncaptured: losses and state within 1e-5 (the merge
    sums a row's duplicates by atomics in any order), one capture."""
    got = _dlrm_step(cuda, False)
    want = _dlrm_step(cuda, True)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    for k, v in got[1].items():
        torch.testing.assert_close(v, want[1][k], rtol=1e-5, atol=1e-5)
    assert got[2].compile_counts()["total"] == 1
    assert next(iter(got[2]._programs.values())).graph is not None


def test_train_session_runs_the_flash_kernels(cuda, tmp_path):
    """A tiny f32 GPT's exported training program on the card: its
    gradients through the loaded program (K1 the operator node, K2 its
    registered backward) within 2e-5 of the eager model's (K1 / K2 through
    the autograd Function), one K1 and one K2 launch per layer each way;
    TrainSession's captured steps launch them through the replays and
    follow TrainStep's losses within 2e-5."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import (TrainSession, TrainStep,
                                      save_train_program)
    from paddle_tpu_torch.models import (GPTConfig, GPTForPretraining,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.ops import flash_attention as fa
    cfg = dict(TRAIN_GPT, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    layers = cfg["num_hidden_layers"]

    def make():
        pt.seed(0)
        model = GPTForPretraining(GPTConfig(**cfg), device=cuda, seed=5)
        crit = GPTPretrainingCriterion()
        return model, (lambda lg, y: crit(lg, y)), pt.optimizer.AdamW(
            1e-3, parameters=model.parameters())
    batches = _train_batches(cuda, "gpt", 3, 2)
    model, fn, opt = make()
    save_train_program(model, fn, opt, str(tmp_path / "gpt"),
                       [((2, 256), "int64"), ((2, 256), "int64")])
    sess = TrainSession(str(tmp_path / "gpt"), device=cuda)
    # gradients: the loaded program against the eager model
    base = _launch_counts()
    # copies: an autograd graph kept alive over the session's own leaves
    # would hold their accumulators on this stream into the capture
    params = {k: sess._state[k].detach().clone().requires_grad_()
              for k in sess._trainable}
    buffers = {k: v.detach() for k, v in sess._state.items()
               if k not in params}
    loss, _ = sess._module(params, buffers,
                           torch.zeros(2, dtype=torch.int64, device=cuda),
                           {}, *batches[0])
    grads = torch.autograd.grad(loss, list(params.values()))
    counts = {k: v - base[k] for k, v in _launch_counts().items()}
    assert counts["flash_fwd"] == counts["flash_bwd"] == layers
    base = _launch_counts()
    eager = fn(model(batches[0][0]), batches[0][1])
    eager.backward()
    counts = {k: v - base[k] for k, v in _launch_counts().items()}
    assert counts["flash_fwd"] == counts["flash_bwd"] == layers
    torch.testing.assert_close(loss, eager, rtol=2e-5, atol=2e-5)
    named = dict(model.named_parameters())
    for k, g in zip(params, grads):
        torch.testing.assert_close(g, named[k].grad, rtol=2e-5, atol=2e-5,
                                   msg=k)
    del loss, grads, eager
    # steps: the session's captured replays against TrainStep
    model2, fn2, opt2 = make()
    step = TrainStep(model2, fn2, opt2)
    got, want = [], []
    for i, b in enumerate(batches):
        base = _launch_counts()
        got.append(sess.step(*b))
        counts = {k: v - base[k] for k, v in _launch_counts().items()}
        if i:   # the first step's capture runs a warm step too
            assert counts["flash_fwd"] == counts["flash_bwd"] == layers
        want.append(float(step(*b)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert next(iter(sess._programs.values())).graph is not None


# ------------------------------------------- the MobileNet and VGG sites

VGG_POOL = ("max", (2, 2), (2, 2), (0, 0))


@pytest.mark.parametrize("hw,c", [(224, 64), (112, 128), (56, 256),
                                  (28, 512), (14, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_pool_at_vgg_sites_on_both_routes(cuda, hw, c, dtype):
    """K9 at VGG-16-BN's pooled sites (batch 4, relu, max 2x2/2/0): by the
    wrapper's plan and by the other route, the window route forced, or,
    where the plan takes the window route, the ring under a hand-made
    plan of its fewest slots (kh + max(kh, sh) = 4), one block per SM,
    where they fit a block's shared memory; both bit-equal to the plain
    version and run to run."""
    from paddle_tpu_torch.ops import _build
    n = 4
    x = _bn_rows(cuda, n * hw * hw, c, dtype, 30).view(n, hw, hw, c)
    coef = _bn_coef(cuda, c, 31)
    dev = cuda.index if cuda.index is not None else 0
    sms, smem = _build.sm_count(dev), _build.smem_limits(dev)
    plan = fbn._pool_plan(n, hw, hw, c, x.element_size(), *VGG_POOL, sms,
                          smem)
    want = fbn._plain_pool_apply(x, coef, "relu", *VGG_POOL)
    calls = [lambda: fbn.bn_pool_apply(x, coef, "relu", *VGG_POOL)]
    slot = -(-hw * c * x.element_size() // 128) * 128
    if plan.route == "ring":
        calls.append(lambda: fbn._pool_window(x, coef, "relu", *VGG_POOL))
    elif fbn._ring_smem(4, slot, c) <= smem[1]:
        forced = fbn.PoolPlan("ring", 4, slot // x.element_size(), hw // 2,
                              min(n, sms))
        calls.append(lambda: fbn._pool_ring(x, coef, "relu", *VGG_POOL,
                                            forced))
    for call in calls:
        got, again = call(), call()
        torch.cuda.synchronize()
        assert got.shape == want.shape == (n, hw // 2, hw // 2, c)
        assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.parametrize("c", [24, 144])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "relu6"])
def test_bn_relu6_and_residual_at_a_mobilenet_v2_site(cuda, c, dtype, act):
    """K6 / K7 / K8 at MobileNetV2's 56 x 56 stage (batch 8) with the
    residual added inside, without an activation (its projection) and
    with relu6, against their plain versions."""
    m = 8 * 56 * 56
    x = _bn_rows(cuda, m, c, dtype, 32)
    g = _bn_rows(cuda, m, c, dtype, 33, shift=0.0)
    r = _bn_rows(cuda, m, c, dtype, 34)
    coef = _bn_coef(cuda, c, 35, backward=True)
    _assert_bn(fbn.bn_apply(x, coef, r, act),
               fbn._plain_apply(x, coef, r, act))
    for got, want in zip(fbn.bn_bwd_reduce(g, x, coef, r, act),
                         fbn._plain_bwd_reduce(g, x, coef, r, act)):
        _assert_bn(got, want)
    for got, want in zip(fbn.bn_bwd_dx(g, x, coef, r, act),
                         fbn._plain_bwd_dx(g, x, coef, r, act)):
        _assert_bn(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "relu6"])
def test_mobilenet_v2_site_fused_call_matches_plain(cuda, dtype, act):
    """One MobileNetV2 site through F.fused_bn_act (training, the
    residual fused in, channels-last memory): the output, the running
    statistics and the gradients of x, gamma, beta and the residual
    against autograd of the plain reference (bn_act_reference, f32 math),
    tolerances as test_bn_functions_match_plain_autograd's; in f32 also
    against the same call with PDTPU_FUSED_BN=0 (batch_norm and the
    composite tail, which in bf16 subtracts a bf16-rounded mean)."""
    import os
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.RandomState(36)
    n, c, h, w = 8, 24, 56, 56

    def act_t():
        t = torch.from_numpy(rng.randn(n, c, h, w).astype(np.float32) + 0.3)
        return t.to(cuda).to(dtype).contiguous(
            memory_format=torch.channels_last)
    x, r, ct = act_t(), act_t(), act_t()
    gamma = torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5).to(cuda)
    beta = torch.from_numpy(rng.randn(c).astype(np.float32)).to(cuda)

    def run(fused=True):
        ins = [t.detach().clone().requires_grad_() for t in (x, gamma, beta,
                                                             r)]
        rm = torch.zeros(c, device=cuda)
        rv = torch.ones(c, device=cuda)
        if fused:
            y = F.fused_bn_act(ins[0], rm, rv, ins[1], ins[2],
                               activation=act, residual=ins[3])
        else:
            y, mean, var = fbn.bn_act_reference(*ins[:3], 1e-5, act, ins[3],
                                                1)
            rm, rv = 0.1 * mean.detach(), 0.9 + 0.1 * var.detach()
        grads = torch.autograd.grad(y, ins, ct)
        return [y.detach(), rm, rv] + list(grads)

    def close(got_all, want_all):
        for got, want in zip(got_all, want_all):
            got, want = got.float(), want.float()
            scale = float(want.abs().max())
            if dtype == torch.bfloat16:
                bad = (got - want).abs() > 2e-2 * scale + 2e-2 * want.abs()
            else:
                bad = (got - want).abs() > 1e-4 * scale
            assert int(bad.sum()) <= got.numel() // 1_000_000, (
                int(bad.sum()), float((got - want).abs().max()), scale)
    launches = fbn.bn_apply.launches
    kern = run()
    assert fbn.bn_apply.launches == launches + 1
    close(kern, run(fused=False))
    if dtype == torch.float32:
        os.environ["PDTPU_FUSED_BN"] = "0"
        try:
            switched = run()
        finally:
            del os.environ["PDTPU_FUSED_BN"]
        assert fbn.bn_apply.launches == launches + 1
        close(kern, switched)


# -- statistics over a process group (the sharded step's BatchNorm) --------

@pytest.fixture
def nccl_one_rank(cuda, tmp_path):
    """A one-rank NCCL process group over a FileStore: the collectives
    between the fused BatchNorm kernels run through NCCL."""
    import torch.distributed as dist
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("form", ["act", "pool"])
def test_bn_group_statistics_on_nccl_match_the_plain_path(nccl_one_rank,
                                                          form):
    """ResNet-50's stem shape (256, 112, 112, 64) NHWC f32 inside
    ``stats_group`` of a one-rank NCCL group: K5 -> all-reduce -> K6 (K9
    at the pooled form) forward and K7 -> all-reduce -> K8 backward (the
    pooled form's plain recompute through the differentiable all-reduce)
    against the plain fused path without a group: outputs, statistics and
    gradients within 1e-4 of each tensor's largest |value|, one
    all-reduce forward and one backward.  The group path divides by the
    all-reduced row count, a device value, where the other divides by a
    host int, so the statistics may differ in their last bit; an output
    within that of the ReLU's kink (|z| ~ 1e-6) then lands on the other
    side of it, and its gradient moves by its whole size: at most one
    element in a million may do so, as in the fused Functions' test."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(256, 112, 112, 64, generator=gen, device="cuda") + 0.5
    gamma = torch.rand(64, generator=gen, device="cuda") + 0.5
    beta = torch.randn(64, generator=gen, device="cuda")
    pool = ("max", 3, 2, 1)

    def run(group):
        ins = [t.clone().requires_grad_() for t in (x, gamma, beta)]
        if form == "act":
            with fbn.stats_group(group):
                y, mean, var = fbn.bn_act_train(*ins, 1e-5, "relu")
        else:
            with fbn.stats_group(group):
                y, mean, var = fbn.bn_act_pool_train(*ins, 1e-5, "relu",
                                                     pool)
        ct = torch.ones_like(y) + 0.01 * torch.arange(
            y.shape[-1], device="cuda")
        grads = torch.autograd.grad(y, ins, ct)
        return [y.detach(), mean, var] + list(grads)
    n0 = fbn.stats_group.all_reduces
    launches = (fbn.bn_stats.launches, fbn.bn_bwd_reduce.launches)
    got = run(nccl_one_rank)
    assert fbn.stats_group.all_reduces - n0 == 2
    assert fbn.bn_stats.launches == launches[0] + 1
    if form == "act":
        assert fbn.bn_bwd_reduce.launches == launches[1] + 1
    want = run(None)
    names = ("y", "mean", "var", "dx", "dgamma", "dbeta")
    for name, g, w in zip(names, got, want):
        g, w = g.detach(), w.detach()
        scale = float(w.abs().max())
        bad = int(((g - w).abs() > 1e-4 * scale).sum())
        assert bad <= g.numel() // 1_000_000, (name, bad, scale)


# -- tensor-parallel serving and the row-sharded table ----------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("h", [4, 8])
def test_paged_attention_at_a_ranks_heads(cuda, h, dtype):
    """K3 at GPT-2 medium's heads per rank under tp 4 (4) and tp 2 (8): 8
    slots, block 16, ragged positions with sentinel tails, in each dtype
    against its plain version; two calls bit-equal."""
    dt = getattr(torch, dtype)
    tol = {"float32": TOL, "bfloat16": BF16_TOL, "float16": F16_TOL}[dtype]
    pos = [17, 150, 300, 511, 512, 700, 901, 1000]
    rng = np.random.RandomState(h * 31)
    args = [a.to(cuda) for a in _paged_case(rng, 8, 8 * 64, 16, h, 64, 64,
                                            pos)]
    args[:3] = [a.to(dt) for a in args[:3]]
    before = pa.paged_attention.launches
    got = pa.paged_attention(*args)
    again = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 2
    torch.testing.assert_close(got.float(), pa._plain(*args).float(), **tol)
    assert torch.equal(got, again)


def test_mesh_engine_captured_on_one_rank_nccl(nccl_one_rank):
    """ServingEngine(mesh=create_mesh({"tp": 1})) on a one-rank NCCL
    group: the rank-local forward (masked embedding rows all-reduced, the
    logits all-gathered) captured with its collectives; greedy streams
    equal the plain engine's and K3 launches through the replays."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.serving import ServingEngine
    m = GPTForPretraining(GPTConfig(
        vocab_size=256, hidden_size=128, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=128,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        initializer_range=0.2), device="cuda", seed=3).eval()
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 256, (n,)) for n in (5, 17, 30)]
    out = {}
    for tag, mesh in (("plain", None),
                      ("mesh", parallel.create_mesh({"tp": 1}))):
        eng = ServingEngine(m, max_slots=4, max_len=64, kv="paged",
                            block_size=16, mesh=mesh, device="cuda")
        warm = eng.warmup()
        assert warm["captured"]
        before = pa.paged_attention.launches
        rs = [eng.submit(p, max_new_tokens=12) for p in prompts]
        eng.run_until_drained(timeout=120)
        out[tag] = [r.tokens() for r in rs]
        assert pa.paged_attention.launches > before
        assert eng.post_warmup_compiles() == 0
        eng.close()
    assert out["mesh"] == out["plain"]


def test_psum_gather_on_one_rank_nccl_is_a_gather(nccl_one_rank):
    """The row-sharded gather over a one-rank NCCL group (its all-reduce
    included) is bit-equal to a plain gather."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.embedding import dedup_ids, psum_gather
    mesh = parallel.create_mesh({"tp": 1})
    rng = np.random.RandomState(8)
    w = torch.from_numpy(rng.randn(1000, 16).astype(np.float32)).to("cuda")
    ids = torch.from_numpy(rng.randint(0, 1000, (3328,))).to("cuda")
    uids, inv, _ = dedup_ids(ids, 1000)
    rows = psum_gather(w, uids.long().clamp(0, 999), "tp", mesh)
    got = rows[inv.long()]
    assert torch.equal(got, w[ids])
