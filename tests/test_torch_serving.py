"""paddle_tpu_torch serving engine against the JAX package on the CPU.

Greedy streams of the port's engine (fixed and paged KV pools, f32 and
int8 weights) equal the JAX engine's streams and the port's own solo
generate; scrub-on-recycle leaves no stale KV in the block pool (held
bit for bit against the JAX engine's pool under the same traffic); KV
exhaustion is backpressure at admission, and a typed KVPoolExhaustedError
mid-decode for a run that can never fit again; an entry point left on its
default device raises without a card."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn.layer.common import Embedding as JEmbedding
from paddle_tpu.nn.layer_base import Layer as JLayer
from paddle_tpu.serving import ServingEngine as JEngine

from paddle_tpu_torch import load_paddle_state
from paddle_tpu_torch.core.errors import InvalidArgumentError, UnavailableError
from paddle_tpu_torch.nn import Embedding, Layer
from paddle_tpu_torch.serving import (KVPoolExhaustedError, QueueFullError,
                                      RequestCancelled, ServingEngine)
from paddle_tpu_torch.utils import faults
from paddle_tpu_torch.utils.monitor import stats

from torch_parity import jax_state, tiny_pair, torch_solo

ENGINE = dict(max_slots=3, max_len=48, prefill_buckets=(8, 16),
              decode_chunk=4, block_size=8)


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "int8"])
def pair(request):
    return tiny_pair(seed=1, quantize=request.param)


@pytest.mark.parametrize("kv", ["fixed", "paged"])
def test_greedy_streams_match_jax_engine_and_solo(pair, kv):
    jm, tm = pair
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 128, (n,)) for n in (4, 7, 11, 14, 5)]
    eng = ServingEngine(tm, kv=kv, device="cpu", **ENGINE)
    eng.warmup()
    ours = [eng.submit(p, max_new_tokens=6 + i) for i, p in enumerate(prompts)]
    sampled = [eng.submit(prompts[0], max_new_tokens=5,
                          decode_strategy="sampling", temperature=0.8,
                          top_k=5, top_p=0.9, seed=s) for s in (3, 3)]
    eng.run_until_drained(timeout=120)
    jeng = JEngine(jm, kv=kv, **ENGINE)
    theirs = [jeng.submit(p, max_new_tokens=6 + i)
              for i, p in enumerate(prompts)]
    jeng.run_until_drained(timeout=240)
    for i, (p, a, b) in enumerate(zip(prompts, ours, theirs)):
        assert a.tokens(timeout=5) == b.tokens(timeout=5)
        assert a.tokens() == torch_solo(tm, p, 6 + i)
    # sampled streams: seeded per request, so the same seed repeats
    assert sampled[0].tokens() == sampled[1].tokens()
    assert eng.metrics()["requests_completed"] == len(prompts) + 2
    assert stats("serving_")["STAT_serving_tokens"] > 0
    if kv == "paged":
        assert eng.kv_pool.used_blocks() == 0


class MarkerModel(Layer):
    """Port of the reference tests' MarkerModel: each written KV row holds
    (token + 1), so a stale-KV leak is visible in the block pool."""

    def __init__(self, vocab=24):
        super().__init__()
        self.emb = Embedding(vocab, vocab, device="cpu")

    def gen_fixed_cache(self, batch_size, max_length, dtype=None):
        shape = (batch_size, max_length, 1, 2)
        return [(torch.zeros(shape), torch.zeros(shape))]

    def forward_fixed(self, input_ids, caches, pos):
        b, s = input_ids.shape
        k, v = caches[0]
        start = torch.as_tensor(pos).reshape(-1, 1).expand(b, 1).clamp(
            0, k.shape[1] - s)
        rows = start + torch.arange(s)
        mark = (input_ids.float() + 1)[:, :, None, None].expand(b, s, 1, 2)
        bidx = torch.arange(b)[:, None]
        k[bidx, rows] = mark
        v[bidx, rows] = mark
        return self.emb(input_ids), [(k, v)]

    def forward_paged(self, input_ids, pools, tables, pos, writes):
        mark = (input_ids[:, 0].float() + 1)[:, None, None].expand(-1, 1, 2)
        kp, vp = pools[0]
        writes.apply(kp, mark)
        writes.apply(vp, mark)
        return self.emb(input_ids)


class JMarkerModel(JLayer):
    """The reference tests' MarkerModel (tests/test_dist_serving.py)."""

    def __init__(self, vocab=24):
        super().__init__()
        self.emb = JEmbedding(vocab, vocab)

    def gen_fixed_cache(self, batch_size, max_length, dtype=None):
        import jax.numpy as jnp
        return [(jnp.zeros((batch_size, max_length, 1, 2), jnp.float32),
                 jnp.zeros((batch_size, max_length, 1, 2), jnp.float32))]

    def forward_fixed(self, input_ids, caches, pos):
        import jax
        import jax.numpy as jnp
        from paddle_tpu.core.tensor import unwrap
        ids = unwrap(input_ids)
        b, s = ids.shape
        logits = unwrap(self.emb(input_ids)).astype(jnp.float32)
        k, v = caches[0]
        chunk = jnp.broadcast_to(
            (ids.astype(k.dtype) + 1)[:, :, None, None], (b, s, 1, 2))
        p = unwrap(pos)
        k = jax.lax.dynamic_update_slice(k, chunk, (0, p, 0, 0))
        v = jax.lax.dynamic_update_slice(v, chunk, (0, p, 0, 0))
        return logits, [(k, v)]


def test_recycled_blocks_are_scrubbed_and_pool_matches_jax():
    """A long tenant dirties the pool; a short one recycles its blocks.
    Every re-served block holds only the short tenant's markers and
    zeros, and the whole pool equals the JAX engine's after the same
    traffic."""
    paddle.seed(3)
    jm = JMarkerModel()
    jm.eval()
    tm = MarkerModel()
    load_paddle_state(tm, jax_state(jm))
    cfg = dict(max_slots=1, max_len=32, prefill_buckets=(8,),
               decode_chunk=2, kv="paged", block_size=4, num_blocks=8)
    eng = ServingEngine(tm, device="cpu", **cfg)
    jeng = JEngine(jm, **cfg)
    for e in (eng, jeng):
        e.submit(np.arange(1, 7), max_new_tokens=20)
        e.run_until_drained(timeout=60)
    k_before = eng._pools[0][0].numpy().copy()
    dirty = {b for b in range(8) if np.any(k_before[b] != 0)}
    assert len(dirty) >= 5, "sanity: the long tenant must have left KV"
    mark = len(eng.kv_pool.served_log)
    r2 = eng.submit(np.arange(7, 11), max_new_tokens=6)
    eng.run_until_drained(timeout=60)
    j2 = jeng.submit(np.arange(7, 11), max_new_tokens=6)
    jeng.run_until_drained(timeout=60)
    assert r2.tokens() == j2.tokens()
    served = set(list(eng.kv_pool.served_log)[mark:])
    assert served and served <= dirty, "sanity: re-served blocks were dirty"
    k = eng._pools[0][0].numpy()
    allowed = ({0.0, 1.0} | {float(v + 1) for v in range(7, 11)}
               | {float(t + 1) for t in r2.tokens()})
    for b in served:
        leaked = set(np.unique(k[b]).tolist()) - allowed
        assert not leaked, f"block {b} leaked prior-tenant KV {leaked}"
    np.testing.assert_array_equal(k, np.asarray(jeng._pools[0][0]))
    np.testing.assert_array_equal(eng._pools[0][1].numpy(),
                                  np.asarray(jeng._pools[0][1]))


def test_fixed_slot_reuse_keeps_no_stale_kv():
    _, tm = tiny_pair(seed=1)
    eng = ServingEngine(tm, kv="fixed", device="cpu", **ENGINE)
    rng = np.random.RandomState(5)
    long_p, short_p = rng.randint(0, 128, (12,)), rng.randint(0, 128, (4,))
    for _ in range(eng.max_slots):
        eng.submit(long_p, max_new_tokens=20)
    eng.run_until_drained(timeout=120)
    rs = [eng.submit(short_p, max_new_tokens=5)
          for _ in range(eng.max_slots)]
    eng.run_until_drained(timeout=120)
    want = torch_solo(tm, short_p, 5)
    assert all(r.tokens() == want for r in rs)


def test_kv_exhaustion_mid_decode_fails_newest_typed():
    """Two runs that cannot both grow in a 4-block pool capped live at 3
    blocks (PDTPU_FAULT_KV_EXHAUST): they take turns parked, the newer
    one, which would need all 4 blocks, fails with KVPoolExhaustedError
    once it can never fit, and the older one finishes equal to solo."""
    _, tm = tiny_pair(seed=1)
    eng = ServingEngine(tm, max_slots=2, max_len=48, prefill_buckets=(8,),
                        decode_chunk=4, kv="paged", block_size=8,
                        num_blocks=4, device="cpu")
    p1, p2 = [1, 2, 3, 4], [5, 6, 7]
    r1 = eng.submit(p1, max_new_tokens=20)      # 23 rows: 3 blocks
    r2 = eng.submit(p2, max_new_tokens=28)      # 30 rows: 4 blocks
    faults.enable("kv_exhaust", "3")
    try:
        eng.run_until_drained(timeout=120)
    finally:
        faults.reset()
    assert r1.tokens() == torch_solo(tm, p1, 20)
    with pytest.raises(KVPoolExhaustedError):
        r2.tokens(timeout=5)
    assert r2.finish_reason == "error"
    assert eng.kv_pool.used_blocks() == 0
    assert eng.metrics()["kv_pool"]["oom_failed"] == 1
    assert eng.metrics()["kv_pool"]["oom_preempts"] >= 1
    # the engine keeps serving
    r3 = eng.submit(p2, max_new_tokens=6)
    eng.run_until_drained(timeout=60)
    assert r3.tokens() == torch_solo(tm, p2, 6)


def test_kv_exhaustion_admission_is_backpressure():
    _, tm = tiny_pair(seed=1)
    eng = ServingEngine(tm, max_slots=2, max_len=48, prefill_buckets=(8, 16),
                        decode_chunk=4, kv="paged", block_size=8,
                        num_blocks=2, device="cpu")
    p1, p2 = list(range(1, 10)), list(range(2, 11))  # bucket 16: 2 blocks
    r1 = eng.submit(p1, max_new_tokens=8)
    r2 = eng.submit(p2, max_new_tokens=8)
    eng.step()
    assert eng.scheduler.occupancy() == 1, "second must wait on blocks"
    assert eng.scheduler.queue_depth() == 1
    eng.run_until_drained(timeout=120)
    assert r1.tokens() == torch_solo(tm, p1, 8)
    assert r2.tokens() == torch_solo(tm, p2, 8)
    with pytest.raises(InvalidArgumentError, match="KV blocks"):
        eng.submit(p1, max_new_tokens=20)   # 28 rows: 4 blocks, never fits


def test_queue_cancel_and_background_loop():
    _, tm = tiny_pair(seed=1)
    eng = ServingEngine(tm, max_slots=1, max_len=32, prefill_buckets=(8,),
                        max_queue_depth=1, device="cpu")
    r = eng.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(QueueFullError):
        eng.submit([1, 2, 3], max_new_tokens=4)
    r.cancel()
    eng.run_until_drained(timeout=30)
    with pytest.raises(RequestCancelled):
        r.tokens(timeout=5)
    eng.start()
    try:
        r = eng.submit([4, 5, 6], max_new_tokens=5)
        assert r.tokens(timeout=60) == torch_solo(tm, [4, 5, 6], 5)
    finally:
        eng.close()
    with pytest.raises(UnavailableError):
        eng.submit([1], max_new_tokens=1)


def test_engine_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, tm = tiny_pair(seed=1)
    with pytest.raises(UnavailableError):
        ServingEngine(tm, max_len=32)


def test_signature_is_the_reference_one_then_device():
    """The reference's parameters, name by name and position by position,
    then ``device``: a positional call binds the same values in both."""
    import inspect
    ref = list(inspect.signature(JEngine.__init__).parameters.items())
    got = list(inspect.signature(ServingEngine.__init__).parameters.items())
    assert [n for n, _ in got] == [n for n, _ in ref] + ["device"]
    for (name, p), (_, q) in zip(got, ref):
        assert (p.kind, p.default) == (q.kind, q.default), name
    _, tm = tiny_pair(seed=1)
    # model, max_slots, max_len, buckets, queue, pad, dtype, profile,
    # decode_chunk: as the reference binds them
    eng = ServingEngine(tm, 2, 32, (8, 16), 4, 0, None, True, 3,
                        device="cpu")
    assert (eng.max_slots, eng.max_len, eng.buckets, eng.decode_chunk,
            eng._profile, eng.kv) == (2, 32, (8, 16), 3, True, "fixed")
    # mesh= is ported: a parallel.Mesh serves (one rank here), anything
    # else is refused typed
    from paddle_tpu_torch import parallel
    eng = ServingEngine(tm, device="cpu", mesh=parallel.create_mesh(
        {"tp": 1}))
    assert eng.metrics()["mesh"] == {"devices": 1, "tp": 1}
    with pytest.raises(InvalidArgumentError, match="parallel.Mesh"):
        ServingEngine(tm, device="cpu", mesh=object())
    # program sets are ported: a set that is not there is refused typed
    from paddle_tpu_torch.programs import ProgramSetError
    with pytest.raises(ProgramSetError, match="unreadable"):
        ServingEngine(tm, device="cpu", program_set="programs/")


def test_request_surface_is_the_reference_one():
    """``Request.__init__``, ``make_request`` and ``submit`` take the
    reference's parameters name by name and position by position, and
    ``Request`` / ``PreemptedRun`` carry the reference's fields: a
    positional call binds the same values in both."""
    import inspect
    from paddle_tpu.serving import PreemptedRun as JPreempted
    from paddle_tpu.serving import Request as JRequest
    from paddle_tpu_torch.serving import PreemptedRun, Request
    for ours, theirs in ((Request.__init__, JRequest.__init__),
                         (ServingEngine.make_request, JEngine.make_request),
                         (ServingEngine.submit, JEngine.submit)):
        got = [(n, p.kind, p.default) for n, p in
               inspect.signature(ours).parameters.items()]
        ref = [(n, p.kind, p.default) for n, p in
               inspect.signature(theirs).parameters.items()]
        assert got == ref, ours.__qualname__
    assert PreemptedRun.__slots__ == JPreempted.__slots__
    assert Request.__slots__ == JRequest.__slots__
    args = (7, [1, 2, 3], 4, True, 1.0, 0, 1.0, None, 5, None, 1, "t",
            False, "s", True, "a")
    ours, theirs = Request(*args), JRequest(*args)
    for f in JRequest.__slots__:
        if f not in ("prompt", "deadline"):
            assert getattr(ours, f) == getattr(theirs, f), f
    assert (ours.session, ours.resubmit, ours.adapter, ours.migrations) == (
        "s", True, "a", 0)
    _, tm = tiny_pair(seed=1)
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    with pytest.raises(InvalidArgumentError, match="greedy-only"):
        eng.make_request([1, 2], 3, decode_strategy="sampling",
                         resubmit=True)
    # dtype, block, timeout, then spec, tenant, adapter: as the reference
    r = eng.submit([1, 2, 3], 3, "greedy_search", 1.0, 0, 1.0, None, 4,
                   None, False, None, False, "t9")
    assert (r.request.spec, r.request.tenant, r.request.priority) == (
        False, "t9", 0)
    eng.run_until_drained(timeout=60)
    req, resp = eng.make_request([1, 2, 3], 8, session="s1")
    assert eng.try_admit(req, resp)
    eng.step()
    paused = eng.preempt_slot(next(iter(eng._slots)))
    from paddle_tpu_torch.serving.transfer import engine_config_hash
    assert paused.source_config_hash == engine_config_hash(eng)
    assert paused.req.session == "s1"
    eng.close()
