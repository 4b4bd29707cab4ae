"""paddle_tpu_torch ops against the JAX package on the CPU: the import
isolation of the port, the int8 dequant-matmul (K4) and paged attention
(K3) plain versions against the reference's fallback AND its Pallas kernel
run through the interpreter, and the block-pool primitives' clip/drop
rules.  Inputs are drawn with numpy from a seed and handed to both."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import int8_matmul as jim
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.quantization import quantize_weight_int8 as jquant

from paddle_tpu_torch.core.errors import UnavailableError
from paddle_tpu_torch.ops import int8_matmul as tim
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.quantization import quantize_weight_int8 as tquant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tiny shapes gain nothing from intra-op threads, and idle OpenMP threads
# spinning would take cores from the test files running beside this one
torch.set_num_threads(1)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'paddle_tpu' or m.startswith('paddle_tpu.')]\n"
        "print(len([m for m in sys.modules"
        " if m.startswith('paddle_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# K4: int8 weight-only dequant-matmul
# ---------------------------------------------------------------------------

SHAPES = [(5, 32, 128), (16, 64, 256), (300, 32, 128)]


@pytest.mark.parametrize("per_channel", [True, False])
def test_quantize_weight_int8_bit_equal(per_channel):
    rng = np.random.RandomState(0)
    # includes exact .5 grid points: both frameworks round half to even
    w = rng.randn(64, 96).astype(np.float32)
    w[0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 0.0, -2.5],
                        np.float32) * (np.abs(w[:, :8]).max(0) / 127.0)
    jw, js = jquant(w, per_channel=per_channel)
    tw, ts = tquant(torch.from_numpy(w), per_channel=per_channel)
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("interpret", [False, True])
def test_dequant_matmul_plain_matches_reference(m, k, n, interpret):
    """Port plain version vs the reference's jnp fallback and its Pallas
    kernel via the interpreter; atol = rtol = 1e-5 (f32 sums in another
    order)."""
    rng = np.random.RandomState(m + k + n)
    x = rng.randn(m, k).astype(np.float32)
    wi, s = jquant(rng.randn(k, n).astype(np.float32))
    jim._INTERPRET = interpret
    try:
        want = np.asarray(jim.dequant_matmul(jnp.asarray(x), wi,
                                             s.reshape(1, -1)))
    finally:
        jim._INTERPRET = False
    before = tim.dequant_matmul.launches
    got = tim.dequant_matmul(torch.from_numpy(x),
                             torch.from_numpy(np.array(wi)),
                             torch.from_numpy(np.array(s)).reshape(1, -1))
    assert tim.dequant_matmul.launches == before, "CPU must not count"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_dequant_matmul_batch_dims_and_per_tensor_scale():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 3, 32).astype(np.float32)
    wi, s = jquant(rng.randn(32, 64).astype(np.float32), per_channel=False)
    want = np.asarray(jim.dequant_matmul(jnp.asarray(x), wi, s))
    got = tim.dequant_matmul(torch.from_numpy(x),
                             torch.from_numpy(np.array(wi)),
                             torch.from_numpy(np.array(s)))
    assert got.shape == (2, 3, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# GPT-2 medium's four Linears per layer, (K, N)
GPT2_MEDIUM_LINEARS = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)]
H100_SMS = 132  # streaming multiprocessors of an H100 SXM


@pytest.mark.parametrize("m", [1, 8, 16, 33, 512])
@pytest.mark.parametrize("k,n", GPT2_MEDIUM_LINEARS + [(32, 128), (96, 144),
                                                      (300, 48)])
def test_int8_plan_covers_k_once_in_one_cluster(m, k, n):
    """Every K row is summed by exactly one cluster rank; a cluster has at
    most 8 blocks and its size divides the grid; the tile is one the
    kernel is built for."""
    p = tim._plan(m, k, n, H100_SMS)
    assert 1 <= p.splits <= 8
    grid = p.grid(m, n)
    assert grid[0] % p.splits == 0
    rows = [r for rank in range(p.splits)
            for r in range(rank * p.k_rows, min((rank + 1) * p.k_rows, k))]
    assert sorted(rows) == list(range(k)) and len(set(rows)) == k
    assert all(rank * p.k_rows < k for rank in range(p.splits)), "empty rank"
    assert (p.mt, p.tn) in {(8, 32), (16, 32), (32, 16), (32, 32), (32, 64)}
    assert grid[1] * p.tn >= n and grid[2] * p.mt >= m


@pytest.mark.parametrize("k,n", GPT2_MEDIUM_LINEARS)
def test_int8_plan_puts_the_decode_weight_in_flight_at_once(k, n):
    """At GPT-2 medium's decode M (8 slots) every thread's k-rows fit its
    one chunk of register words, so the whole weight is loaded in one
    round; at the largest prefill bucket the grid gives the card >= 2
    blocks per SM."""
    p = tim._plan(8, k, n, H100_SMS)
    groups = tim.THREADS // (p.tn // 4)
    assert p.k_rows <= groups * tim.WORDS[p.mt]
    blocks = p.grid(8, n)
    words = blocks[0] * blocks[1] * blocks[2] * tim.THREADS * tim.WORDS[p.mt]
    assert 4 * words >= k * n
    pre = tim._plan(512, k, n, H100_SMS)
    g = pre.grid(512, n)
    assert g[0] * g[1] * g[2] >= 2 * H100_SMS


# ---------------------------------------------------------------------------
# K3: paged attention + block-pool primitives
# ---------------------------------------------------------------------------

def _paged_inputs(seed, s=3, nb_pool=10, bs=4, h=2, d=8, nb=4):
    rng = np.random.RandomState(seed)
    kpool = rng.randn(nb_pool, bs, h, d).astype(np.float32)
    vpool = rng.randn(nb_pool, bs, h, d).astype(np.float32)
    q = rng.randn(s, h, d).astype(np.float32)
    # tail entries hold the allocator's out-of-range sentinel
    tables = np.array([[7, 2, 9, nb_pool], [1, nb_pool, nb_pool, nb_pool],
                       [3, 4, 5, 6]], np.int32)[:s]
    pos = np.array([9, 2, 15], np.int32)[:s]  # ragged, not block multiples
    return q, kpool, vpool, tables, pos


@pytest.mark.parametrize("interpret", [False, True])
def test_paged_attention_plain_matches_reference(interpret):
    q, kp, vp, tables, pos = _paged_inputs(0)
    jpa._INTERPRET = interpret
    try:
        want = np.stack([np.asarray(jpa.paged_attention(
            jnp.asarray(q[i]), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables[i]), int(pos[i]))) for i in range(len(q))])
    finally:
        jpa._INTERPRET = False
    before = tpa.paged_attention.launches
    got = tpa.paged_attention(*(torch.from_numpy(a) for a in
                                (q, kp, vp, tables, pos)))
    assert tpa.paged_attention.launches == before, "CPU must not count"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("live", [0, 1, 7, 8, 9, 17, 463, 1000, 1024])
@pytest.mark.parametrize("max_blocks", [1, 3, 8, 64, 256])
def test_paged_plan_covers_live_rows_once(live, max_blocks):
    """Every live row of a slot is taken by exactly one cluster rank; a
    cluster has at most 8 blocks and its size divides the grid."""
    p = tpa._plan(8, 16, 64, max_blocks, H100_SMS)
    assert 1 <= p.splits <= 8
    assert p.grid(8, 16)[0] % p.splits == 0
    per = -(-live // p.splits)  # the kernel's rule, from pos on the device
    rows = [r for rank in range(p.splits)
            for r in range(min(rank * per, live), min((rank + 1) * per, live))]
    assert rows == list(range(live))


@pytest.mark.parametrize("h,d", [(16, 64), (2, 32), (4, 128), (1, 256),
                                 (2, 96)])
def test_paged_plan_fills_the_card_at_decode(h, d):
    """GPT-2 medium's decode (8 slots, 16 heads of 64, a 64-entry table)
    gives the card >= 2 blocks per SM; every plan's heads divide H and a
    block's row fits the kernel's 512 floats and 2048-float tiles."""
    p = tpa._plan(8, h, d, 64, H100_SMS)
    assert h % p.hpb == 0 and p.hpb * d <= 512
    assert p.tile_rows >= 1 and p.tile_rows * p.hpb * d <= 2048
    if (h, d) == (16, 64):
        s, hg, sl = p.grid(8, h)
        assert s * hg * sl >= 2 * H100_SMS


def test_gather_block_rows_clips_like_reference():
    _, kp, _, tables, _ = _paged_inputs(1)
    tables = tables.copy()
    tables[1, 2] = -5                      # negative ids clip to 0 as well
    for row in tables:
        want = np.asarray(jpa.gather_block_rows(jnp.asarray(kp),
                                                jnp.asarray(row)))
        got = tpa.gather_block_rows(torch.from_numpy(kp),
                                    torch.from_numpy(row))
        np.testing.assert_array_equal(got.numpy(), want)
    batched = tpa.gather_block_rows(torch.from_numpy(kp),
                                    torch.from_numpy(tables))
    assert batched.shape == (3, 16, 2, 8)


def test_scatter_scrub_write_drop_out_of_range_like_reference():
    rng = np.random.RandomState(2)
    pool = rng.randn(5, 2, 3).astype(np.float32)
    ids = np.array([1, 5, 3, 99, 7], np.int32)       # 5, 99, 7 drop
    offs = np.array([1, 0, 0, 1, 1], np.int32)
    rows = rng.randn(5, 3).astype(np.float32)
    want = np.asarray(jpa.scatter_block_rows(jnp.asarray(pool),
                                             jnp.asarray(ids),
                                             jnp.asarray(offs),
                                             jnp.asarray(rows)))
    got = tpa.scatter_block_rows(torch.from_numpy(pool.copy()), ids, offs,
                                 torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)

    scrub = np.array([2, 7, 0, 5], np.int32)
    want = np.asarray(jpa.scrub_blocks(jnp.asarray(pool), jnp.asarray(scrub)))
    got = tpa.scrub_blocks(torch.from_numpy(pool.copy()),
                           torch.from_numpy(scrub))
    np.testing.assert_array_equal(got.numpy(), want)

    # a negative id drops too (the reference would wrap it NumPy-style;
    # the allocator never produces one)
    same = tpa.scatter_block_rows(torch.from_numpy(pool.copy()), [-1], [0],
                                  torch.from_numpy(rows[:1]))
    np.testing.assert_array_equal(same.numpy(), pool)

    blocks = rng.randn(3, 2, 3).astype(np.float32)
    bid = np.array([4, 5, 0], np.int32)
    want = np.asarray(jnp.asarray(pool).at[jnp.asarray(bid)].set(
        jnp.asarray(blocks), mode="drop"))
    got = tpa.write_blocks(torch.from_numpy(pool.copy()), bid,
                           torch.from_numpy(blocks))
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_writes_scrub_entered_blocks_then_scatter():
    """The decode step's write plan = the reference's _paged_row_writer:
    scrub every block entered at offset 0, then scatter; sentinel drops."""
    rng = np.random.RandomState(3)
    pool = rng.randn(6, 4, 2).astype(np.float32)
    ids = np.array([2, 6, 4], np.int32)     # 6 is the sentinel
    offs = np.array([0, 0, 3], np.int32)
    rows = rng.randn(3, 2).astype(np.float32)
    jp = jpa.scrub_blocks(jnp.asarray(pool),
                          jnp.where(jnp.asarray(offs) == 0,
                                    jnp.asarray(ids), 6))
    want = np.asarray(jpa.scatter_block_rows(jp, jnp.asarray(ids),
                                             jnp.asarray(offs),
                                             jnp.asarray(rows)))
    plan = tpa.RowWrites(ids, offs, 6, torch.device("cpu"))
    got = plan.apply(torch.from_numpy(pool.copy()), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from paddle_tpu_torch.core.device import resolve_device
    with pytest.raises(UnavailableError):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
