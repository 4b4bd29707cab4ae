"""The serving engine's program family and keyed sampling of
paddle_tpu_torch against the JAX package on the CPU.

- The keyed sampler (``generation.keyed``) reproduces ``jax.random``:
  ``fold_in`` and the random bits bit for bit, the gumbel noise within
  1e-6 (the two libraries' f32 ``log`` may differ in the last bit: one
  unit is at most 9.5e-7 below 16, and |gumbel| < 16 in f32).
- Sampled streams of the tiny f32 GPT equal the reference engine's for
  the same seeds and knobs (fixed and paged KV), and a sampled request
  gives the same tokens alone, in another slot and among other requests;
  greedy streams equal the reference's and solo ``generate()``.
- The static-shape paged writes (``SlotRowWrites``, ``write_slot_blocks``)
  leave the real blocks equal to the host-planned writes, and the engine's
  pool equal to the reference engine's after admission / release churn.
- The programs read nothing on the host: with every host read patched to
  raise, the prefills (the cached-suffix prefill too), both decode
  programs and the copy-on-write block copy still run.
- ``compile_counts()`` stays at its bound and ``post_warmup_compiles()``
  at 0 over greedy, sampled, churned and OOM-preempted traffic.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.serving import ServingEngine as JEngine

from paddle_tpu_torch import load_paddle_state
from paddle_tpu_torch.generation import keyed
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.serving import ServingEngine

from test_torch_serving import JMarkerModel, MarkerModel
from torch_parity import jax_state, tiny_pair, torch_solo

ENGINE = dict(max_slots=3, max_len=48, prefill_buckets=(8, 16),
              decode_chunk=4, block_size=8)
GUMBEL_ATOL = 1e-6
KEY_CASES = [(0, 0, 1), (1, 5, 7), (2, 47, 128), (3, 1023, 1000),
             (4, 2 ** 31 + 9, 50304)]
# (prompt length, max_new, knobs): greedy and sampled requests mixed
TRAFFIC = [(4, 8, {}),
           (7, 10, dict(temperature=0.8, top_k=5, top_p=0.9, seed=3)),
           (11, 9, dict(temperature=1.3, seed=7)),
           (14, 7, {}),
           (5, 12, dict(temperature=0.7, top_p=0.85, seed=11)),
           (9, 6, dict(temperature=1.0, top_k=20, seed=3))]


def _key(seed):
    return np.random.RandomState(seed).randint(
        0, 2 ** 32, size=2, dtype=np.uint64).astype(np.uint32)


def _torch_keys(keys):
    return torch.from_numpy(np.asarray(keys, np.uint32).astype(np.int64))


@pytest.mark.parametrize("seed,pos,n", KEY_CASES)
def test_fold_in_and_bits_match_jax_bit_for_bit(seed, pos, n):
    key = _key(seed)
    want = jax.random.fold_in(jnp.asarray(key), pos)
    got = keyed.fold_in(_torch_keys(key[None]),
                        torch.tensor([pos], dtype=torch.int64))
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(want).astype(np.int64))
    bits = keyed.random_bits(got, n)[0].numpy()
    np.testing.assert_array_equal(
        bits, np.asarray(jax.random.bits(want, (n,), jnp.uint32)).astype(
            np.int64))


@pytest.mark.parametrize("seed,pos,n", KEY_CASES)
def test_gumbel_matches_jax(seed, pos, n):
    key = _key(seed)
    want = np.asarray(jax.random.gumbel(
        jax.random.fold_in(jnp.asarray(key), pos), (n,)))
    got = keyed.gumbel(keyed.fold_in(_torch_keys(key[None]),
                                     torch.tensor([pos])), n)[0].numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=GUMBEL_ATOL)


def test_batched_keys_are_independent_rows_and_request_key_matches():
    """A (S, 2) batch of keys at (S,) positions gives each row what that
    key alone gives; request_key is the reference engine's _request_key."""
    keys = np.stack([_key(s) for s in (5, 6, 7)])
    pos = torch.tensor([3, 0, 40], dtype=torch.int32)
    batch = keyed.gumbel(keyed.fold_in(_torch_keys(keys), pos), 64)
    for i in range(3):
        alone = keyed.gumbel(keyed.fold_in(_torch_keys(keys[i:i + 1]),
                                           pos[i:i + 1]), 64)
        torch.testing.assert_close(batch[i:i + 1], alone, rtol=0, atol=0)
    ref = types.SimpleNamespace(_key_width=2)
    for seed in (0, 3, 2 ** 31 + 5):
        req = types.SimpleNamespace(seed=seed)
        np.testing.assert_array_equal(keyed.request_key(seed),
                                      JEngine._request_key(ref, req))


def _run(engine, traffic):
    resps = [engine.submit(np.arange(1, n + 1) * 3 % 128, max_new_tokens=m,
                           **({"decode_strategy": "sampling", **kn}
                              if kn else {}))
             for n, m, kn in traffic]
    engine.run_until_drained(timeout=240)
    return [r.tokens(timeout=5) for r in resps], resps


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=1)


@pytest.fixture(scope="module", params=["fixed", "paged"])
def streams(request, pair):
    """The same greedy + sampled traffic through the reference engine and
    the port's (one engine each, requests queued past the slots)."""
    jm, tm = pair
    jeng = JEngine(jm, kv=request.param, **ENGINE)
    want, jresps = _run(jeng, TRAFFIC)
    eng = ServingEngine(tm, kv=request.param, device="cpu", **ENGINE)
    got, resps = _run(eng, TRAFFIC)
    return request.param, eng, want, got, jresps, resps


def test_sampled_streams_match_reference_engine(streams):
    _, _, want, got, jresps, resps = streams
    for (_, _, kn), a, b in zip(TRAFFIC, got, want):
        assert a == b, f"stream differs for {kn}"
    for a, b in zip(resps, jresps):   # summed log-probs of the streams
        np.testing.assert_allclose(a.logprob, b.logprob, rtol=1e-4,
                                   atol=1e-4)


def test_greedy_streams_match_reference_and_solo(streams, pair):
    _, tm = pair
    _, _, want, got, _, _ = streams
    for (n, m, kn), a, b in zip(TRAFFIC, got, want):
        if not kn:
            assert a == b == torch_solo(tm, np.arange(1, n + 1) * 3 % 128, m)


def test_compile_counts_stay_at_the_bound(streams):
    kv, eng, *_ = streams
    counts = eng.compile_counts()
    assert counts["total"] == counts["bound"] == len(ENGINE[
        "prefill_buckets"]) + 2
    assert counts["decode"] == 2
    assert counts["prefill"] == {b: 1 for b in ENGINE["prefill_buckets"]}
    assert eng.post_warmup_compiles() == 0


@pytest.mark.parametrize("kv", ["fixed", "paged"])
def test_sampled_request_ignores_its_slot_and_batch(pair, kv):
    """One sampled request alone, in the last slot behind two others, and
    among other sampled requests: the same tokens each time."""
    _, tm = pair
    knobs = dict(decode_strategy="sampling", temperature=1.1, top_k=30,
                 seed=21)
    prompt = [5, 9, 2, 7, 1]
    runs = []
    for before in ([], [dict(), dict()],
                   [dict(decode_strategy="sampling", seed=s)
                    for s in (1, 2)]):
        eng = ServingEngine(tm, kv=kv, device="cpu", **ENGINE)
        others = [eng.submit([3, 4, 5, 6], max_new_tokens=9, **kn)
                  for kn in before]
        r = eng.submit(prompt, max_new_tokens=10, **knobs)
        eng.run_until_drained(timeout=120)
        runs.append(r.tokens(timeout=5))
        assert all(len(o.tokens(timeout=5)) == 9 for o in others)
    assert runs[0] == runs[1] == runs[2]


def _random_tables(rng, s, nb, num_blocks):
    """Disjoint block tables with sentinel tails."""
    ids = rng.permutation(num_blocks)
    tables = np.full((s, nb), num_blocks, np.int32)
    for i in range(s):
        used = rng.randint(0, nb + 1)
        tables[i, :used] = ids[i * nb:i * nb + used]
    return tables


@pytest.mark.parametrize("seed", range(4))
def test_slot_row_writes_equal_host_row_writes(seed):
    """The static-shape decode writes against the host-planned ones
    (``RowWrites``, as ``paged_decode_logits`` plans them) on the same
    tables, positions (offset 0 included, and past pool_len) and active
    mask: the real blocks bit-equal, only trash blocks touched past them."""
    rng = np.random.RandomState(seed)
    s, nb, bs, num_blocks, pool_len = 5, 4, 4, 24, 14
    tables = _random_tables(rng, s, nb, num_blocks)
    pos = rng.randint(0, pool_len + 3, size=s)
    pos[0] = 4                        # enters its second block
    active = rng.rand(s) < 0.7
    pool = rng.randn(num_blocks + s, bs, 2, 3).astype(np.float32)
    rows = rng.randn(s, 2, 3).astype(np.float32)
    want = torch.from_numpy(pool[:num_blocks].copy())
    bidx = np.clip(pos // bs, 0, nb - 1)
    blk = tables[np.arange(s), bidx]
    ok = active & (pos < pool_len)
    tpa.RowWrites(np.where(ok, blk, num_blocks), pos % bs, num_blocks,
                  torch.device("cpu")).apply(want, torch.from_numpy(rows))
    got = torch.from_numpy(pool.copy())
    tpa.SlotRowWrites(torch.from_numpy(tables), torch.from_numpy(
        pos.astype(np.int32)), torch.from_numpy(active), num_blocks, bs,
        pool_len).apply(got, torch.from_numpy(rows))
    np.testing.assert_array_equal(got[:num_blocks].numpy(), want.numpy())


def test_write_slot_blocks_equals_write_blocks():
    rng = np.random.RandomState(7)
    pool = rng.randn(10 + 4, 2, 3).astype(np.float32)
    blocks = rng.randn(4, 2, 3).astype(np.float32)
    table = np.array([6, 10, 1, 10], np.int32)     # 10: the sentinel
    want = tpa.write_blocks(torch.from_numpy(pool[:10].copy()), table,
                            torch.from_numpy(blocks))
    got = tpa.write_slot_blocks(torch.from_numpy(pool.copy()),
                                torch.from_numpy(table),
                                torch.from_numpy(blocks), 10)
    np.testing.assert_array_equal(got[:10].numpy(), want.numpy())


def test_paged_pool_matches_reference_after_churn():
    """Marker KV (each row holds its token + 1) under admission and
    release churn in a small pool, two slots: the port's real blocks
    equal the reference engine's pool bit for bit."""
    paddle.seed(3)
    jm = JMarkerModel()
    jm.eval()
    tm = MarkerModel()
    load_paddle_state(tm, jax_state(jm))
    cfg = dict(max_slots=2, max_len=32, prefill_buckets=(8,),
               decode_chunk=3, kv="paged", block_size=4, num_blocks=10)
    traffic = [(np.arange(1, 7), 9), (np.arange(2, 5), 5),
               (np.arange(8, 15), 12), (np.arange(3, 6), 3),
               (np.arange(1, 4), 14)]
    eng = ServingEngine(tm, device="cpu", **cfg)
    jeng = JEngine(jm, **cfg)
    for e in (eng, jeng):
        rs = [e.submit(p, max_new_tokens=m) for p, m in traffic]
        e.run_until_drained(timeout=120)
        assert all(r.finish_reason == "length" for r in rs)
    assert len(eng.kv_pool.served_log) > cfg["num_blocks"], \
        "sanity: blocks were re-served"
    for (k, v), (jk, jv) in zip(eng._pools, jeng._pools):
        assert k.shape[0] == cfg["num_blocks"]
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def _no_host_reads(monkeypatch):
    """Make every host read of a tensor, and every tensor made from host
    data (on the card: a host-to-card copy), raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("a program read a tensor on the host")

    for name in ("cpu", "numpy", "item", "tolist", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(tpa, "_host_ids", refuse)
    monkeypatch.setattr(torch, "from_numpy", refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    as_tensor = torch.as_tensor

    def tensors_only(data, *args, **kwargs):
        if not isinstance(data, torch.Tensor):
            refuse()
        return as_tensor(data, *args, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", tensors_only)
    setitem = torch.Tensor.__setitem__

    def tensor_values_only(self, index, value):
        # a Python value written through a tensor index is copied to the
        # card from the host (a basic-index fill is not)
        idx = index if isinstance(index, tuple) else (index,)
        if not isinstance(value, torch.Tensor) and any(
                isinstance(i, torch.Tensor) for i in idx):
            refuse()
        return setitem(self, index, value)

    monkeypatch.setattr(torch.Tensor, "__setitem__", tensor_values_only)


@pytest.mark.parametrize("kv", ["fixed", "paged", "paged_prefix"])
def test_programs_read_nothing_on_the_host(pair, kv, monkeypatch):
    """The prefill and both decode programs (with the prefix cache: the
    cached-suffix prefill on a warm admission's inputs) and the
    copy-on-write block copy run with every host read refused."""
    _, tm = pair
    prefix = kv == "paged_prefix"
    eng = ServingEngine(tm, kv="paged" if prefix else kv,
                        prefix_cache=prefix, device="cpu", **ENGINE)
    eng.submit(list(range(1, 17)) if prefix else [4, 8, 15],
               max_new_tokens=20, decode_strategy="sampling", seed=5)
    # with the prefix cache: a warm admission (8 cached rows, bucket 8)
    eng.submit([1, 2, 3, 4, 5, 6, 7, 8, 40, 41, 42] if prefix
               else [16, 23, 42, 1, 2, 3, 4, 5, 6], max_new_tokens=20)
    eng.step()                 # warm up, admit both, one decode chunk
    if prefix:
        assert eng.prefix_cache.hits == 1
        assert int(eng._programs[8].inputs["cached_len"]) == 8
    with torch.inference_mode():
        eng._rebuild_batch()
        if kv != "fixed":
            eng._sync_tables(True)
        # the prefills share their scalar buffers: run the bucket of the
        # last admission (prefix: the warm one, 8; else 16)
        bucket = 8 if prefix else ENGINE["prefill_buckets"][-1]
        names = ("decode", "decode_greedy", bucket)
        with monkeypatch.context() as m:
            _no_host_reads(m)
            out = {name: eng._programs[name].run() for name in names}
            if prefix:
                tpa.copy_block(eng._pool_store, eng.kv_pool.block_ids(0)[0],
                               eng.kv_pool._free[-1])
    toks, logps, finites, tokens, pos = out["decode"]
    assert toks.shape == (ENGINE["decode_chunk"], ENGINE["max_slots"])
    assert bool(finites.all()) and tokens.shape == pos.shape
    assert out[bucket][0].shape == (1,)


def test_compile_counts_stay_zero_over_churn_and_oom(pair):
    """Greedy and sampled traffic, releases and mid-decode OOM preemption
    and restore on a paged engine: nothing is made after warmup."""
    _, tm = pair
    eng = ServingEngine(tm, max_slots=2, max_len=48, prefill_buckets=(8,),
                        decode_chunk=4, kv="paged", block_size=8,
                        num_blocks=4, device="cpu")
    assert eng.post_warmup_compiles() == -1
    eng.warmup()
    assert eng.compile_counts()["total"] == 3
    r1 = eng.submit([1, 2, 3, 4], max_new_tokens=20)
    r2 = eng.submit([5, 6, 7], max_new_tokens=20,
                    decode_strategy="sampling", seed=9)
    eng.run_until_drained(timeout=120)
    assert r1.tokens() == torch_solo(tm, [1, 2, 3, 4], 20)
    assert len(r2.tokens(timeout=5)) == 20
    assert r1.request.preempts + r2.request.preempts >= 1
    r3 = eng.submit([5, 6, 7], max_new_tokens=20, decode_strategy="sampling",
                    seed=9)
    eng.run_until_drained(timeout=60)
    assert r3.tokens(timeout=5) == r2.tokens()
    assert eng.post_warmup_compiles() == 0
    assert eng.compile_counts()["total"] == 3
