"""Preemption and KV-pool pressure of paddle_tpu_torch's serving engine
against the JAX package on the CPU.

The tiny GPT (2 layers, hidden 64, 4 heads; f32 and int8 weights carried
from the reference by ``load_paddle_state``), prompts from numpy seeds:

- A paged engine whose pool is smaller than every slot's worst case
  completes every request (runs are parked and resumed, not failed), and
  its streams equal the reference engine's token for token, greedy and
  keyed-sampled (tolerance: none, token equality).
- ``preempt_slot`` / ``restore_run`` round trips on the paged and the
  fixed pool: the resumed stream equals the uninterrupted one (solo
  ``generate`` and the reference engine's, token equality); the snapshot
  holds the pool's rows [0, pos) bit for bit; restore writes them back in
  place into the pool the programs read.
- A parked run honours cancel and deadline; one that can never fit again
  (``PDTPU_FAULT_KV_EXHAUST``) fails with KVPoolExhaustedError, as does a
  queued request whose prompt bucket can never admit; ``try_admit``
  places a request directly; nothing is made after warmup.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.utils import faults as jfaults

from paddle_tpu_torch.serving import (DeadlineExceededError,
                                      KVPoolExhaustedError, PreemptedRun,
                                      RequestCancelled, ServingEngine)
from paddle_tpu_torch.utils import faults
from paddle_tpu_torch.utils.retry import Deadline

from torch_parity import tiny_pair, torch_solo

# a pool of 7 blocks of 8 rows for 2 slots of 48 rows (12 blocks would
# back both): two long runs cannot both grow
PRESSURE = dict(max_slots=2, max_len=48, prefill_buckets=(8,),
                decode_chunk=4, kv="paged", block_size=8, num_blocks=7)
PAGED = dict(max_slots=3, max_len=48, prefill_buckets=(8, 16),
             decode_chunk=4, kv="paged", block_size=8)
SAMPLED = dict(decode_strategy="sampling", temperature=0.8, top_k=20,
               top_p=0.9)


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "int8"])
def pair(request):
    return tiny_pair(seed=1, quantize=request.param)


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    faults.reset()
    jfaults.reset()


def _pressure_traffic(engine):
    """Four long runs, two greedy and two keyed-sampled, all queued."""
    rng = np.random.RandomState(2)
    return [engine.submit(rng.randint(0, 128, (n,)), max_new_tokens=m,
                          **(dict(SAMPLED, seed=s) if s else {}))
            for n, m, s in ((4, 30, 0), (3, 30, 5), (6, 28, 0), (5, 26, 7))]


def test_pool_pressure_completes_every_request_as_the_reference(pair):
    """The pool holds 7 blocks where 12 would back both slots: runs are
    preempted and parked as they grow, resume as the pool drains, and
    every stream equals the reference engine's (token equality).  Before
    the port parked runs, the newest one failed here."""
    jm, tm = pair
    jeng = JEngine(jm, **PRESSURE)
    want = [r.tokens(timeout=5) for r in _run_all(jeng, _pressure_traffic)]
    eng = ServingEngine(tm, device="cpu", **PRESSURE)
    resps = _run_all(eng, _pressure_traffic)
    got = [r.tokens(timeout=5) for r in resps]
    assert got == want
    kv = eng.metrics()["kv_pool"]
    assert kv["oom_preempts"] >= 1, "sanity: the pool must run short"
    assert kv["oom_resumes"] == kv["oom_preempts"]
    assert kv["oom_failed"] == 0 and kv["oom_paused"] == 0
    assert kv["used_blocks"] == 0
    assert sum(r.request.preempts for r in resps) == kv["oom_preempts"]
    assert all(r.request.resumes == r.request.preempts for r in resps)
    assert eng.metrics()["requests_completed"] == len(resps)
    assert eng.post_warmup_compiles() == 0


def _run_all(engine, traffic):
    resps = traffic(engine)
    engine.run_until_drained(timeout=240)
    return resps


def _step_until_active(eng, n=1):
    for _ in range(20):
        eng.step()
        if len(eng._slots) >= n:
            return
    raise AssertionError("no run became active")


@pytest.mark.parametrize("kv", ["fixed", "paged"])
def test_preempt_restore_round_trip_equals_uninterrupted(pair, kv):
    """A run preempted after two steps frees its slot (and blocks), keeps
    its stream open, and restored into another slot continues it: the
    stream equals solo generate and the reference engine doing the same
    (token equality)."""
    jm, tm = pair
    cfg = dict(PAGED, kv=kv)
    prompt = [2, 4, 6]
    streams = []
    for make in (lambda: JEngine(jm, **cfg),
                 lambda: ServingEngine(tm, device="cpu", **cfg)):
        eng = make()
        r = eng.submit(prompt, max_new_tokens=20)
        eng.step()
        eng.step()
        (slot,) = eng._slots
        if kv == "paged":
            used = eng.kv_pool.used_blocks()
        paused = eng.preempt_slot(slot)
        assert not r.done() and not eng._slots
        if kv == "paged":
            assert eng.kv_pool.used_blocks() == 0 < used
        # occupy the freed slot so the restore lands in another one
        other = eng.submit([9, 9], max_new_tokens=8)
        _step_until_active(eng)
        assert eng.restore_run(paused)
        assert [s for s, run in eng._slots.items()
                if run.req is r.request] != [slot]
        eng.run_until_drained(timeout=240)
        assert other.done()
        assert r.request.preempts == 1 and r.request.resumes == 1
        streams.append(r.tokens(timeout=5))
    assert streams[0] == streams[1] == torch_solo(tm, prompt, 20)


@pytest.mark.parametrize("kv", ["fixed", "paged"])
def test_snapshot_holds_the_rows_and_restore_writes_them_in_place(pair, kv):
    """The snapshot's rows equal the pool's rows [0, pos) bit for bit; the
    restore writes the same values back into the same pool tensors (the
    ones the programs were made over: no tensor is replaced)."""
    _, tm = pair
    eng = ServingEngine(tm, device="cpu", **dict(PAGED, kv=kv))
    r = eng.submit(np.arange(1, 12), max_new_tokens=14)
    eng.step()
    eng.step()
    (slot, run), = eng._slots.items()
    pos = run.pos
    if kv == "paged":
        ids = eng.kv_pool.block_ids(slot)
        before = [t[ids].reshape((-1,) + tuple(t.shape[2:]))[:pos].clone()
                  for pair_ in eng._pools for t in pair_]
    else:
        before = [t[slot, :pos].clone() for pair_ in eng._pools
                  for t in pair_]
    store = [t.data_ptr() for pair_ in eng._pool_store for t in pair_]
    paused = eng.preempt_slot(slot)
    assert paused.pos == pos and paused.produced == run.produced
    snap = [t for rows in paused.kv_rows for t in rows]
    for got, want in zip(snap, before):
        assert got.device.type == "cpu" and got.shape[0] == pos
        assert torch.equal(got, want)
    assert eng.restore_run(paused)
    (slot2, run2), = eng._slots.items()
    assert run2.pos == pos and run2.produced == paused.produced
    if kv == "paged":
        ids = eng.kv_pool.block_ids(slot2)
        after = [t[ids].reshape((-1,) + tuple(t.shape[2:]))
                 for pair_ in eng._pools for t in pair_]
        for t in after:     # the last block's tail is zero-filled
            assert not t[pos:].any()
        after = [t[:pos] for t in after]
    else:
        after = [t[slot2, :pos] for pair_ in eng._pools for t in pair_]
    for got, want in zip(after, before):
        assert torch.equal(got, want)
    assert [t.data_ptr() for pair_ in eng._pool_store for t in pair_] == store
    eng.run_until_drained(timeout=120)
    assert r.tokens(timeout=5) == torch_solo(tm, np.arange(1, 12), 14)


def test_restore_from_state_and_try_admit(pair):
    """A PreemptedRun rebuilt from raw state restores like the original;
    try_admit places a request without the queue and refuses when every
    slot is taken."""
    _, tm = pair
    eng = ServingEngine(tm, device="cpu", **dict(PAGED, max_slots=1))
    req, resp = eng.make_request([3, 1, 4, 1, 5], 12, **dict(SAMPLED,
                                                           seed=3))
    assert eng.try_admit(req, resp)
    busy = eng.make_request([2, 7], 3)
    assert not eng.try_admit(*busy), "the only slot is taken"
    eng.step()
    p = eng.preempt_slot(next(iter(eng._slots)))
    rebuilt = PreemptedRun.from_state(p.req, p.resp, p.pos, p.produced,
                                      p.last_token, p.key, p.kv_rows)
    assert eng.restore_run(rebuilt)
    eng.run_until_drained(timeout=120)
    alone = ServingEngine(tm, device="cpu", **dict(PAGED, max_slots=1))
    want = alone.submit([3, 1, 4, 1, 5], 12, **dict(SAMPLED, seed=3))
    alone.run_until_drained(timeout=120)
    assert resp.tokens(timeout=5) == want.tokens(timeout=5)
    assert eng.try_admit(*busy)
    eng.run_until_drained(timeout=60)
    assert busy[1].tokens(timeout=5) == torch_solo(tm, [2, 7], 3)


def _parked_engine(tm):
    """An engine with one run parked on pool pressure (and one active)."""
    eng = ServingEngine(tm, device="cpu", **PRESSURE)
    resps = _pressure_traffic(eng)
    for _ in range(40):
        eng.step()
        if eng._oom_paused:
            return eng, resps
    raise AssertionError("no run was parked")


@pytest.mark.parametrize("how", ["cancel", "deadline", "never_fits"])
def test_parked_run_honours_cancel_deadline_and_fails_typed(pair, how):
    _, tm = pair
    eng, resps = _parked_engine(tm)
    parked = eng._oom_paused[0]
    if how == "cancel":
        parked.resp.cancel()
        exc = RequestCancelled
    elif how == "deadline":
        parked.req.deadline = Deadline(0.0)      # expired
        exc = DeadlineExceededError
    else:
        # the pool shrinks under it: its next step can never fit again
        faults.enable("kv_exhaust", str(eng.kv_pool.blocks_for(parked.pos)
                                        - 1))
        exc = KVPoolExhaustedError
    eng.step()
    assert parked.resp.done() and parked not in eng._oom_paused
    with pytest.raises(exc):
        parked.resp.tokens(timeout=5)
    faults.reset()
    eng.run_until_drained(timeout=240)
    assert all(r.done() for r in resps)
    kv = eng.metrics()["kv_pool"]
    assert kv["oom_paused"] == 0 and kv["used_blocks"] == 0
    assert kv["oom_failed"] == (1 if how == "never_fits" else 0)


def test_queued_request_that_can_never_admit_fails_typed(pair):
    """Under a live cap below a queued prompt's bucket the request fails
    with KVPoolExhaustedError instead of waiting forever; disarming the
    cap restores full service."""
    _, tm = pair
    eng = ServingEngine(tm, device="cpu", **PAGED)
    faults.enable("kv_exhaust", "1")
    r = eng.submit(np.arange(1, 12), max_new_tokens=4)   # bucket 16: 2
    eng.run_until_drained(timeout=60)
    with pytest.raises(KVPoolExhaustedError):
        r.tokens(timeout=5)
    assert eng.metrics()["requests_errored"] == 1
    faults.reset()
    r2 = eng.submit(np.arange(1, 12), max_new_tokens=4)
    eng.run_until_drained(timeout=60)
    assert r2.tokens(timeout=5) == torch_solo(tm, np.arange(1, 12), 4)


def test_close_fails_parked_runs(pair):
    _, tm = pair
    eng, resps = _parked_engine(tm)
    parked = eng._oom_paused[0]
    eng.close()
    with pytest.raises(RequestCancelled):
        parked.resp.tokens(timeout=5)
    assert all(r.done() for r in resps)
