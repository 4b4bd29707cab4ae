"""The prefix cache of paddle_tpu_torch's paged serving engine against the
JAX package on the CPU.

- Allocator and index: the reference's ``PagedKVPool`` + ``PrefixCache``
  and the port's, driven by the same operation sequences (the reference
  tests' and seeded random ones), give equal results and equal state
  after every operation: chains, refcounts, tables, free lists (order
  included), cached sets, LRU order and eviction order (exact equality).
- Engine (the tiny GPT, 2 layers, hidden 64, 4 heads; f32 and int8
  weights carried by ``load_paddle_state``; prompts from numpy seeds):
  warm streams equal the reference prefix engine's, the port's cold
  engine's and solo ``generate`` (token equality, greedy and
  keyed-sampled) with nothing made after warmup; a fully cached prompt
  takes copy-on-write; preempt/restore re-pins the prefix; tenants are
  isolated unless grouped; the PDTPU_FAULT_PREFIX_EVICT cap is live;
  shared blocks are never written (bit for bit).
"""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import PagedKVPool as JPool
from paddle_tpu.serving import PrefixCache as JCache
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.utils import faults as jfaults

from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.serving import PagedKVPool, PrefixCache, ServingEngine
from paddle_tpu_torch.utils import faults

from torch_parity import tiny_pair, torch_solo

ENGINE = dict(max_slots=3, max_len=48, prefill_buckets=(8, 16),
              decode_chunk=4, kv="paged", block_size=8)
SAMPLED = dict(decode_strategy="sampling", temperature=0.8, top_k=4, seed=11)


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    faults.reset()
    jfaults.reset()


# ---------------------------------------------------------------------------
# allocator + radix index: reference against port, operation by operation
# ---------------------------------------------------------------------------

def _state(pool, cache):
    """Everything the two implementations must agree on."""
    return (list(pool._free), sorted(pool._refs.items()),
            sorted((s, list(t)) for s, t in pool._tables.items()),
            sorted(pool._cached), pool._live, pool.used_blocks(),
            pool.free_blocks(), pool.cached_blocks(),
            [cache._nodes[n].block for n in cache._lru],
            sorted((k, cache._nodes[n].block, cache._nodes[n].children)
                   for k, n in cache._index.items()),
            cache.hits, cache.misses, cache.evictions, cache.cow_copies,
            {k: v for k, v in pool.stats().items() if k != "pool"},
            cache.stats())


def _replay(pool_cls, cache_cls, geometry, ops):
    """Apply ``ops`` to a fresh pool + cache; the result of every op (or
    the name of the error it raised) and the state after it."""
    pool = pool_cls(*geometry)
    cache = cache_cls(pool)
    trace = []
    for op, *args in ops:
        try:
            if op == "alloc":
                out = pool.alloc(*args)
            elif op == "ensure":
                out = pool.ensure(*args)
            elif op == "free":
                out = pool.free(*args)
            elif op == "adopt":          # the chain a match of tokens gives
                key, toks, slot = args
                out = pool.adopt(slot, cache.match(key, toks))
            elif op == "insert":
                key, toks, slot = args
                out = cache.insert(key, toks, pool.block_ids(slot))
            elif op == "match":
                out = cache.match(*args)
            elif op == "evict":
                out = cache.evict(*args)
            elif op == "cow":
                out = pool.cow_last(*args)
                if out is not None:
                    cache.note_cow()
            elif op == "kv_cap":
                jfaults.enable("kv_exhaust", str(args[0]))
                out = None
            elif op == "evict_cap":
                jfaults.enable("prefix_evict", str(args[0]))
                out = None
            elif op == "disarm":
                jfaults.reset()
                out = None
        except Exception as e:  # noqa: BLE001 — both must raise alike
            out = ("raises", type(e).__name__)
        trace.append((op, out, _state(pool, cache)))
    jfaults.reset()
    return trace


T12 = np.arange(12, dtype=np.int32)
SCENARIOS = {
    # the reference's test_radix_match_insert_and_share_partition
    "match_insert_partition": ((16, 4, 32), [
        ("alloc", 0, 12), ("insert", "a", T12, 0), ("match", "a", T12),
        ("match", "a", T12[:8]),
        ("match", "a", np.concatenate([T12[:8], [99, 98, 97, 96]])),
        ("match", "a", T12[:6]),
        ("match", "a", np.concatenate([[9], T12[1:]])),
        ("match", "b", T12), ("alloc", 1, 12), ("insert", "a", T12, 1),
        ("match", "a", T12, True)]),
    # test_lru_eviction_is_leaf_first_and_refcount_aware
    "lru_leaf_first": ((8, 4, 32), [
        ("alloc", 0, 12), ("insert", "t", T12, 0), ("evict", 3),
        ("free", 0), ("evict", 1), ("match", "t", T12),
        ("adopt", "t", T12, 1), ("evict", 2), ("free", 1), ("evict", 2)]),
    # test_refcount_lifecycle_and_cached_counts_as_free
    "refcount_lifecycle": ((8, 4, 32), [
        ("alloc", 0, 8), ("insert", "t", T12[:8], 0),
        ("adopt", "t", T12[:8], 1), ("free", 0), ("free", 1),
        ("alloc", 2, 32)]),
    # test_cow_last_gives_private_copy
    "cow_last": ((4, 4, 16), [
        ("alloc", 0, 8), ("insert", "t", T12[:8], 0),
        ("adopt", "t", T12[:8], 1), ("cow", 1), ("free", 1), ("free", 0)]),
    # the live fault caps: capacity, reclaim under pressure, cow refused
    "fault_caps": ((10, 4, 32), [
        ("alloc", 0, 12), ("insert", "k", T12, 0), ("free", 0),
        ("kv_cap", 4), ("alloc", 1, 16), ("adopt", "k", T12, 2),
        ("disarm",), ("adopt", "k", T12, 2), ("cow", 2), ("kv_cap", 5),
        ("cow", 2), ("disarm",), ("free", 2), ("free", 1),
        ("evict_cap", 1), ("alloc", 3, 12), ("insert", "k", T12 + 1, 3),
        ("free", 3), ("evict_cap", 0), ("alloc", 4, 4), ("free", 4),
        ("disarm",), ("alloc", 5, 40)]),
}


def _random_ops(seed, n=60):
    """A random operation sequence over 4 slots and 2 share keys (an op
    the state does not allow raises, alike in both)."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, 3, (int(rng.randint(4, 17)),))
               for _ in range(6)]
    held, ops = set(), []
    for _ in range(n):
        slot = int(rng.randint(4))
        key = "ab"[rng.randint(2)]
        toks = prompts[rng.randint(len(prompts))]
        r = rng.rand()
        if slot in held and r < 0.3:
            ops.append(("free", slot))
            held.discard(slot)
        elif slot in held and r < 0.5:
            ops.append(("ensure", slot, int(rng.randint(1, 33))))
        elif slot in held and r < 0.6:
            ops.append(("cow", slot))
        elif slot in held:
            ops.append(("insert", key, toks, slot))
        elif r < 0.5:
            ops.append(("alloc", slot, int(rng.randint(1, 20))))
            held.add(slot)
        elif r < 0.8:
            ops.append(("adopt", key, toks, slot))
            held.add(slot)
        elif r < 0.9:
            ops.append(("evict", int(rng.randint(1, 4))))
        else:
            ops.append(("match", key, toks, True))
    return (12, 4, 32), ops


def _check_equal_traces(geometry, ops):
    want = _replay(JPool, JCache, geometry, ops)
    got = _replay(PagedKVPool, PrefixCache, geometry, ops)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"op {i} {ops[i][0]}: port {g} != reference {w}"


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pool_and_cache_match_the_reference(name):
    _check_equal_traces(*SCENARIOS[name])


@pytest.mark.parametrize("seed", range(4))
def test_pool_and_cache_match_the_reference_on_random_sequences(seed):
    geometry, ops = _random_ops(seed)
    _check_equal_traces(geometry, ops)


# ---------------------------------------------------------------------------
# the engine: port against the reference engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["f32", "int8"])
def setup(request):
    """(reference model, port model, reference prefix engine, port prefix
    engine, port cold engine), each engine warmed up.  The two prefix
    engines see the same traffic in the same order, so their caches stay
    in step across the tests."""
    jm, tm = tiny_pair(seed=1, quantize=request.param)
    jeng = JEngine(jm, prefix_cache=True, **ENGINE)
    jeng.warmup()
    eng = ServingEngine(tm, prefix_cache=True, device="cpu", **ENGINE)
    eng.warmup()
    cold = ServingEngine(tm, device="cpu", **ENGINE)
    cold.warmup()
    return jm, tm, jeng, eng, cold


def _both(setup, traffic):
    """The same traffic through the reference and the port prefix engines
    (drained); the port's streams must equal the reference's."""
    _, _, jeng, eng, _ = setup
    out = []
    for e in (jeng, eng):
        resps = traffic(e)
        e.run_until_drained(timeout=240)
        out.append([r.tokens(timeout=5) for r in resps])
    assert out[1] == out[0]
    assert eng.prefix_cache.stats() == jeng.prefix_cache.stats()
    assert eng.kv_pool.used_blocks() == 0
    return out[1], resps


def _cached_checksums(eng):
    """Every cached block's k/v content, by block id."""
    blocks = sorted(n.block for n in eng.prefix_cache._nodes.values())
    return {b: [t[b].clone() for pair in eng._pools for t in pair]
            for b in blocks}


def test_warm_streams_equal_cold_and_reference_with_zero_captures(setup):
    """Mixed warm and cold greedy and sampled traffic: every stream equals
    the reference prefix engine's, the port's no-cache engine's and (greedy)
    solo generate; the cache hits; nothing is made after warmup."""
    _, tm, _, eng, cold = setup
    before = eng.compile_counts()
    rng = np.random.RandomState(4)
    template = rng.randint(0, 128, (16,))
    warm = [np.concatenate([template[:8], rng.randint(0, 128, (n,))])
            for n in (3, 5, 7)]
    outsider = rng.randint(0, 128, (11,))

    def traffic(e):
        first = e.submit(template.copy(), max_new_tokens=6)
        e.run_until_drained(timeout=240)
        return ([first] + [e.submit(p, max_new_tokens=6) for p in warm]
                + [e.submit(outsider, max_new_tokens=6),
                   e.submit(warm[0], max_new_tokens=5, **SAMPLED)])

    hits = eng.prefix_cache.hits
    got, _ = _both(setup, traffic)
    want = [r.tokens(timeout=5) for r in _drained(cold, traffic)]
    assert got == want
    for p, toks in zip([template] + warm + [outsider], got):
        assert toks == torch_solo(tm, p, 6)
    assert eng.prefix_cache.hits > hits, "the warm requests must hit"
    assert eng.compile_counts() == before
    assert before["total"] == before["bound"] == len(eng.buckets) + 2
    assert eng.post_warmup_compiles() == 0


def _drained(e, traffic):
    resps = traffic(e)
    e.run_until_drained(timeout=240)
    return resps


def test_fully_cached_prompt_takes_copy_on_write(setup):
    """A block-aligned prompt seen before is cached to its last block: the
    slot gets a private copy of that block (one copy-on-write), its stream
    equals solo, and the shared blocks are unchanged bit for bit."""
    _, tm, _, eng, _ = setup
    p = np.random.RandomState(9).randint(0, 128, (16,))
    _both(setup, lambda e: [e.submit(p, max_new_tokens=6)])
    cows = eng.prefix_cache.cow_copies
    shared = _cached_checksums(eng)
    got, _ = _both(setup, lambda e: [e.submit(p, max_new_tokens=6)])
    assert got == [torch_solo(tm, p, 6)]
    assert eng.prefix_cache.cow_copies == cows + 1
    after = _cached_checksums(eng)
    for b, tensors in shared.items():
        assert all(torch.equal(x, y) for x, y in zip(tensors, after[b]))
    stats = eng.metrics()["kv_pool"]["prefix_cache"]
    assert stats["cow_copies"] == eng.prefix_cache.cow_copies
    assert stats["hit_rate"] > 0


def test_shared_blocks_are_never_written(setup):
    """Warm admissions (suffixes entering at a block boundary), a
    copy-on-write admission and their decode steps leave every block
    cached before them bit for bit unchanged."""
    _, _, _, eng, _ = setup
    rng = np.random.RandomState(17)
    template = rng.randint(0, 128, (16,))
    _both(setup, lambda e: [e.submit(template.copy(), max_new_tokens=3)])
    shared = _cached_checksums(eng)
    assert len(shared) >= 2
    warm = np.concatenate([template[:8], rng.randint(0, 128, (5,))])
    _both(setup, lambda e: [
        e.submit(warm, max_new_tokens=12),
        e.submit(template.copy(), max_new_tokens=12),            # cow
        e.submit(np.concatenate([template[:8], [1, 2]]), max_new_tokens=9,
                 **SAMPLED)])
    after = _cached_checksums(eng)
    for b, tensors in shared.items():
        assert b in after, "a referenced chain was evicted"
        assert all(torch.equal(x, y) for x, y in zip(tensors, after[b]))


def test_preempt_restore_repins_the_prefix(setup):
    """A preempted warm run restores equal to solo: its shared prefix is
    adopted again from the cache (not uploaded) and nothing double-frees."""
    _, tm, _, eng, _ = setup
    rng = np.random.RandomState(13)
    template = rng.randint(0, 128, (16,))
    p = np.concatenate([template[:8], rng.randint(0, 128, (4,))])
    want = torch_solo(tm, p, 8)
    streams = []
    for e in setup[2:4]:
        e.submit(template.copy(), max_new_tokens=1)
        e.run_until_drained(timeout=240)
        r = e.submit(p, max_new_tokens=8)
        for _ in range(20):
            e.step()
            if e._slots:
                break
        (slot,) = e._slots
        chain = e.prefix_cache.match("default", p)
        assert e.kv_pool.block_ids(slot)[:1] == chain
        paused = e.preempt_slot(slot)
        assert e.kv_pool.used_blocks() == 0
        assert e.restore_run(paused)
        (slot,) = e._slots
        assert e.kv_pool.block_ids(slot)[:1] == chain, "prefix re-pinned"
        e.run_until_drained(timeout=240)
        streams.append(r.tokens(timeout=5))
        assert e.kv_pool.used_blocks() == 0
    assert streams == [want, want]


def test_tenant_isolation_and_share_groups(setup):
    """A block cached by one tenant is never mapped into another's table
    without a share group; with one, the group's tenants reuse it."""
    _, tm, _, eng, _ = setup
    p = np.random.RandomState(21).randint(0, 128, (16,))
    want = [torch_solo(tm, p, 4)]
    assert _both(setup, lambda e: [e.submit(p.copy(), 4, tenant="alice")]
                 )[0] == want
    a_chain = eng.prefix_cache.match("alice", p)
    assert len(a_chain) == 2
    hits = eng.prefix_cache.hits
    assert _both(setup, lambda e: [e.submit(p.copy(), 4, tenant="bob")]
                 )[0] == want
    assert eng.prefix_cache.hits == hits, "a cross-tenant hit is a leak"
    b_chain = eng.prefix_cache.match("bob", p)
    assert b_chain and set(b_chain).isdisjoint(a_chain)
    for e in setup[2:4]:
        e.set_share_groups({"alice": "team", "carol": "team"})
    assert _both(setup, lambda e: [e.submit(p.copy(), 4, tenant="carol")]
                 )[0] == want
    hits = eng.prefix_cache.hits
    assert _both(setup, lambda e: [e.submit(p.copy(), 4, tenant="alice")]
                 )[0] == want
    assert eng.prefix_cache.hits > hits, "a share group must enable reuse"
    for e in setup[2:4]:
        e.set_share_groups({})


def test_prefix_evict_cap_is_live(setup):
    _, _, _, eng, _ = setup
    rng = np.random.RandomState(31)
    p = rng.randint(0, 128, (16,))
    _both(setup, lambda e: [e.submit(p.copy(), max_new_tokens=4)])
    assert eng.kv_pool.cached_blocks() >= 2
    evictions = eng.prefix_cache.evictions
    faults.enable("prefix_evict", "1")     # read live, by both packages
    p2 = rng.randint(0, 128, (16,))
    _both(setup, lambda e: [e.submit(p2.copy(), max_new_tokens=4)])
    assert eng.kv_pool.cached_blocks() <= 1
    faults.enable("prefix_evict", "0")
    p3 = rng.randint(0, 128, (16,))
    _both(setup, lambda e: [e.submit(p3.copy(), max_new_tokens=4)])
    assert eng.kv_pool.cached_blocks() == 0, "N=0 keeps nothing"
    assert eng.prefix_cache.evictions >= evictions + 2


def test_metrics_report_the_pool_and_the_cache(setup):
    _, _, jeng, eng, _ = setup
    kv = eng.metrics()["kv_pool"]
    jkv = jeng.metrics()["kv_pool"]
    for key in ("used_blocks", "free_blocks", "cached_blocks",
                "shared_blocks", "oom_preempts", "oom_failed",
                "oom_paused", "prefix_cache"):
        assert kv[key] == jkv[key], key
    assert kv["oom_resumes"] == 0


def test_prefix_cache_requires_the_paged_pool():
    _, tm = tiny_pair(seed=1)
    with pytest.raises(InvalidArgumentError):
        ServingEngine(tm, max_slots=2, max_len=32, prefill_buckets=(8,),
                      prefix_cache=True, device="cpu")
