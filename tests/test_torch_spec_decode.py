"""Speculative decoding in paddle_tpu_torch's serving engine against the JAX
package on the CPU.

The tiny GPT of ``torch_parity`` (2 layers, hidden 64, vocab 128) is the
target; drafts are a random 1-layer GPT (the worst case: almost nothing is
accepted), a weight clone (everything is) and a clone with seeded noise
on its weights (about half is), weights carried across by
``load_paddle_state``, prompts from numpy seeds.  Tolerance: none —
tokens, counts and accepts are compared for equality; logps within 1e-6
(the two libraries' f32 ``log`` / ``softmax`` may differ in the last
bit).

- ``draft_proposal_key``, ``keyed.uniform`` and both commit functions
  equal the reference's on seeded inputs.
- Greedy spec streams (fixed and paged pools, f32 and int8) equal solo
  ``generate`` and the reference spec engine's; sampled and spec-off
  streams and the accept counts equal the reference's; spec-off slots
  equal the plain engine's; a clone draft accepts everything.
- Mixed traffic leaves ``compile_counts()`` at ``len(buckets) + 2`` and
  nothing is made after warmup; the verify programs read nothing on the
  host.
- eos and a deadline mid-tick, a full-budget request at the pool's end
  (a marker model makes a clamped write visible), preempt / restore and
  pool pressure (draft rows ride along), the trash sizing of a
  small-bucket engine, the draft_diverge fault, and the configurations
  the reference refuses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.generation import speculative as jspec
from paddle_tpu.quantization import quantize_for_serving as jquantize
from paddle_tpu.serving import ServingEngine as JEngine

from paddle_tpu_torch import load_paddle_state
from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.generation import generate, keyed
from paddle_tpu_torch.generation import speculative as tspec
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
from paddle_tpu_torch.nn import Layer
from paddle_tpu_torch.quantization import quantize_for_serving
from paddle_tpu_torch.serving import DeadlineExceededError, ServingEngine
from paddle_tpu_torch.utils import faults
from paddle_tpu_torch.utils.retry import Deadline

from test_torch_serving_programs import _no_host_reads
from torch_parity import TINY, jax_state, torch_solo

LOGP_ATOL = 1e-6
SPEC = dict(max_slots=3, max_len=48, prefill_buckets=(8, 16), block_size=8,
            spec_tokens=3)
SAMPLED = dict(decode_strategy="sampling", temperature=0.8, top_k=20,
               top_p=0.9)
# (prompt length, max_new, knobs): greedy and sampled, spec on and off
TRAFFIC = [(4, 10, {}),
           (7, 10, {}),
           (11, 10, dict(spec=False)),
           (5, 12, dict(SAMPLED, seed=5)),
           (9, 12, dict(decode_strategy="sampling", temperature=1.1, seed=6,
                        spec=False)),
           (14, 9, dict(decode_strategy="sampling", temperature=0.7,
                        top_p=0.85, seed=7))]


def gpt_pair(seed=1, layers=2, quantize=False, noise=0.0):
    """(jax model, port model) with identical weights; ``noise`` adds
    seeded N(0, noise) to every float weight (a near clone when the seed
    is the target's)."""
    paddle.seed(seed)
    cfg = dict(TINY, num_hidden_layers=layers)
    jm = jmodels.GPTForPretraining(jmodels.GPTConfig(**cfg))
    jm.eval()
    if noise:
        rng = np.random.RandomState(seed + 100)
        jm.set_state_dict({k: v + noise * rng.standard_normal(
            v.shape).astype(v.dtype) for k, v in jax_state(jm).items()})
    tm = GPTForPretraining(GPTConfig(**cfg), device="cpu").eval()
    if quantize:
        jquantize(jm)
        quantize_for_serving(tm)
    load_paddle_state(tm, jax_state(jm))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    """Targets (f32, int8) and drafts: random 1-layer (f32, int8), clone,
    noisy clone."""
    return {"target": gpt_pair(seed=1), "target8": gpt_pair(1, quantize=True),
            "draft": gpt_pair(seed=11, layers=1),
            "draft8": gpt_pair(11, layers=1, quantize=True),
            "clone": gpt_pair(seed=1), "noisy": gpt_pair(seed=1, noise=0.01)}


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    faults.reset()


def _submit_all(engine, traffic, seed=1):
    rng = np.random.RandomState(seed)
    return [engine.submit(rng.randint(0, 128, (n,)), max_new_tokens=m, **kw)
            for n, m, kw in traffic]


def _serve(engine, traffic, seed=1):
    resps = _submit_all(engine, traffic, seed)
    engine.run_until_drained(timeout=240)
    return [r.tokens(timeout=5) for r in resps]


def _spec_counts(engine):
    m = engine.metrics()["spec"]
    return m["ticks"], m["proposed"], m["accepted"]


# (kv, target, draft, traffic): each case builds one reference engine
CASES = {"fixed": ("fixed", "target", "draft", TRAFFIC),
         "paged_int8": ("paged", "target8", "draft8", TRAFFIC),
         "paged_noisy_sampled": ("paged", "target", "noisy",
                                 [(n, 16, dict(SAMPLED, seed=20 + i))
                                  for i, n in enumerate((3, 6, 9, 12))]
                                 + [(5, 16, {})])}


@pytest.fixture(scope="module")
def reference(models):
    """The reference spec engine's streams and counters per case."""
    out = {}
    for name, (kv, target, draft, traffic) in CASES.items():
        eng = JEngine(models[target][0], draft_model=models[draft][0], kv=kv,
                      **SPEC)
        out[name] = (_serve(eng, traffic), _spec_counts(eng))
    return out


# ---------------------------------------------------------------------------
# the commit functions, op by op
# ---------------------------------------------------------------------------

def _key(seed):
    return np.random.RandomState(seed).randint(
        0, 2 ** 32, size=2, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("seed,pos,i", [(0, 0, 0), (3, 47, 2),
                                        (9, 1023, 4)])
def test_draft_key_and_uniforms_bit_equal(seed, pos, i):
    key = _key(seed)
    tkey = torch.from_numpy(key.astype(np.int64))[None]
    want = jspec.draft_proposal_key(jnp.asarray(key), pos, i)
    got = tspec.draft_proposal_key(tkey, torch.tensor([pos]), i)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(want).astype(np.int64))
    u_want = jax.random.uniform(jax.random.fold_in(want, tspec.SALT_ACCEPT),
                                (7,))
    u_got = keyed.uniform(keyed.fold_in(got, tspec.SALT_ACCEPT), 7)
    assert np.array_equal(u_got[0].numpy(), np.asarray(u_want))


def _commit_inputs(seed, s=6, k=3, v=32):
    """Seeded commit inputs: target logits, proposals that match the
    target's argmax about half the time, draft probabilities near the
    target's, mixed greedy / spec-on rows."""
    rng = np.random.RandomState(seed)
    plog = (rng.standard_normal((s, k + 1, v)) * 2.0).astype(np.float32)
    tops = plog.argmax(-1)[:, :k]
    props = np.where(rng.rand(s, k) < 0.6, tops,
                     rng.randint(0, v, (s, k))).astype(np.int64)
    ql = plog[:, :k] + 0.5 * rng.standard_normal((s, k, v)).astype(
        np.float32)
    qs = np.exp(ql - ql.max(-1, keepdims=True))
    qs = (qs / qs.sum(-1, keepdims=True)).astype(np.float32)
    keys = np.stack([_key(seed * 10 + j) for j in range(s)])
    pos = rng.randint(0, 100, (s,)).astype(np.int32)
    greedy = np.array([True, False, False, True, False, False][:s])
    spec_on = np.array([True, True, False, False, True, True][:s])
    return props, qs, plog, keys, pos, greedy, spec_on


@pytest.mark.parametrize("kind", ["greedy", "sampled"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_commit_functions_equal_the_reference(kind, seed):
    props, qs, plog, keys, pos, greedy, spec_on = _commit_inputs(seed)
    if kind == "greedy":
        greedy = np.ones_like(greedy)
    jfn = getattr(jspec, f"commit_speculative_{kind}")
    tfn = getattr(tspec, f"commit_speculative_{kind}")
    want = jfn(jnp.asarray(props, jnp.int32), jnp.asarray(qs),
               jnp.asarray(plog), jnp.asarray(keys), jnp.asarray(pos),
               jnp.asarray(greedy), jnp.asarray(spec_on), 0)
    got = tfn(torch.from_numpy(props), torch.from_numpy(qs),
              torch.from_numpy(plog),
              torch.from_numpy(keys.astype(np.int64)),
              torch.from_numpy(pos), torch.from_numpy(greedy),
              torch.from_numpy(spec_on), 0)
    for name, w, g in zip(("out", "count", "accepted", "last"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=0, atol=LOGP_ATOL)
    if kind == "sampled":   # the inputs reach every branch
        assert 0 < int(got[2].sum()) < props.size


# ---------------------------------------------------------------------------
# streams against the reference engine and solo generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_streams_and_accepts_equal_the_reference(models, reference, case):
    """Every stream (greedy, sampled, spec on and off) and the tick /
    proposal / accept counters equal the reference spec engine's; greedy
    streams equal solo generate; mixed traffic makes nothing after
    warmup."""
    kv, target, draft, traffic = CASES[case]
    tm = models[target][1]
    eng = ServingEngine(tm, draft_model=models[draft][1], kv=kv,
                        device="cpu", **SPEC)
    got = _serve(eng, traffic)
    want, counts = reference[case]
    assert got == want
    assert _spec_counts(eng) == counts
    rng = np.random.RandomState(1)
    for (n, m, kw), toks in zip(traffic, got):
        prompt = rng.randint(0, 128, (n,))
        if "decode_strategy" not in kw:
            assert toks == torch_solo(tm, prompt, m)
    cc = eng.compile_counts()
    assert cc["total"] == cc["bound"] == len(SPEC["prefill_buckets"]) + 2
    assert eng.post_warmup_compiles() == 0
    spec = eng.metrics()["spec"]
    assert set(spec) == {"enabled", "spec_tokens", "ticks", "proposed",
                         "accepted", "accept_rate"}
    if draft == "noisy":    # sampled acceptance really is exercised
        assert 0.2 < spec["accept_rate"] < 0.95, spec


def test_clone_draft_accepts_everything(models):
    """Draft == target: every proposal matches (accept rate exactly 1.0),
    so the K+1-row verify forward agrees with the draft's one-row steps
    row for row; the stream equals solo generate."""
    tm = models["target"][1]
    for kv in ("fixed", "paged"):
        eng = ServingEngine(tm, draft_model=models["clone"][1], kv=kv,
                            device="cpu", **SPEC)
        r = eng.submit([1, 2, 3, 4], max_new_tokens=17)
        eng.run_until_drained(timeout=60)
        assert r.tokens() == torch_solo(tm, [1, 2, 3, 4], 17)
        assert eng.metrics()["spec"]["accept_rate"] == 1.0
        assert eng.metrics()["spec"]["ticks"] == 4


def test_spec_off_slots_equal_the_plain_engine(models):
    """spec=False requests, greedy and keyed-sampled, of a speculative
    engine stream token for token as the plain engine's."""
    tm = models["target"][1]
    traffic = [(n, m, dict(kw, spec=False)) for n, m, kw in TRAFFIC]
    for kv in ("fixed", "paged"):
        eng = ServingEngine(tm, draft_model=models["draft"][1], kv=kv,
                            device="cpu", **SPEC)
        plain = ServingEngine(tm, kv=kv, device="cpu",
                              **{k: v for k, v in SPEC.items()
                                 if k != "spec_tokens"})
        assert _serve(eng, traffic) == _serve(
            plain, [(n, m, {k: v for k, v in kw.items() if k != "spec"})
                    for n, m, kw in traffic])
        assert eng.metrics()["spec"]["proposed"] == 0


def test_verify_programs_read_nothing_on_the_host(models, monkeypatch):
    """Both verify programs (with the draft_diverge input armed) and a
    speculative prefill run with every host read refused."""
    faults.enable("draft_diverge", "2")
    tm = models["target"][1]
    for kv in ("fixed", "paged"):
        eng = ServingEngine(tm, draft_model=models["draft"][1], kv=kv,
                            device="cpu", **SPEC)
        eng.submit([4, 8, 15], max_new_tokens=20, seed=5, **SAMPLED)
        eng.submit(list(range(1, 10)), max_new_tokens=20)
        eng.step()
        with torch.inference_mode():
            eng._rebuild_batch()
            if kv == "paged":
                eng._sync_tables(True)
            with monkeypatch.context() as m:
                _no_host_reads(m)
                out = {name: eng._programs[name].run()
                       for name in ("decode", "decode_greedy", 16)}
        out_toks, _, finite, count = out["decode"][:4]
        assert out_toks.shape == (3, SPEC["spec_tokens"] + 1)
        assert bool(finite.all()) and bool((count >= 1).all())
        assert out[16][0].shape == (1,)


# ---------------------------------------------------------------------------
# the host side of a tick
# ---------------------------------------------------------------------------

def test_eos_mid_tick_discards_the_tail(models):
    tm = models["target"][1]
    want = torch_solo(tm, [1, 2, 3], 12)
    eos = want[2]             # mid-tick: a clone draft commits 4 a tick
    eng = ServingEngine(tm, draft_model=models["clone"][1], device="cpu",
                        **SPEC)
    r = eng.submit([1, 2, 3], max_new_tokens=12, eos_token_id=eos)
    eng.run_until_drained(timeout=60)
    assert r.tokens() == want[:want.index(eos) + 1]
    assert r.finish_reason == "eos"
    assert eng.scheduler.free_slot_count() == eng.max_slots


def test_deadline_mid_tick_delivers_no_later_token(models):
    """A deadline that expires while a tick's four tokens are committed
    stops the stream there: the tokens before it stream, none after."""
    tm = models["target"][1]
    eng = ServingEngine(tm, draft_model=models["clone"][1], device="cpu",
                        **SPEC)
    r = eng.submit([1, 2, 3], max_new_tokens=12)
    eng.step()                # prefill + one tick (4 tokens)
    assert len(r.tokens_so_far()) == 5
    emit = eng._emit

    def emit_then_expire(run, tok, logp):
        emit(run, tok, logp)
        if len(run.resp.tokens_so_far()) == 7:
            run.req.deadline = Deadline(0.0)

    eng._emit = emit_then_expire
    eng.step()                # the tick's third token finds it expired
    with pytest.raises(DeadlineExceededError):
        r.tokens(timeout=5)
    assert r.tokens_so_far() == torch_solo(tm, [1, 2, 3], 12)[:7]
    assert eng.scheduler.free_slot_count() == eng.max_slots


class SumMarker(Layer):
    """A clamp detector (the reference tests' ``_MarkerModel``): a KV row
    holds position + token + 1 and the greedy token is the masked prefix
    sum mod 97, so one misplaced or clamped write changes the stream."""

    VOCAB = 97

    def gen_fixed_cache(self, batch_size, max_length, dtype=None):
        shape = (batch_size, max_length, 1, 1)
        return [(torch.zeros(shape), torch.zeros(shape))]

    def forward_fixed(self, input_ids, caches, pos):
        b, s = input_ids.shape
        k, v = caches[0]
        p = torch.as_tensor(pos).reshape(-1, 1).expand(b, 1)
        q_idx = p + torch.arange(s)                               # (b, s)
        rows = p.clamp(0, k.shape[1] - s) + torch.arange(s)
        k[torch.arange(b)[:, None], rows] = (
            q_idx + 1 + input_ids).float()[..., None, None]
        live = torch.arange(k.shape[1])[None, None] <= q_idx[..., None]
        sums = (k[:, None, :, 0, 0] * live).sum(-1)
        tok = torch.remainder(sums, self.VOCAB).long()
        return torch.nn.functional.one_hot(tok, self.VOCAB).float(), [(k, v)]


def test_full_budget_request_at_the_pool_end(models):
    """plen + max_new == max_len: the last ticks write K+1 rows past
    max_len, into the pools' K rows of headroom (without them the fixed
    pool's write would clamp onto committed KV).  The marker model on the
    fixed pool, and the tiny GPT with a clone draft (all-accept ticks up
    to the end) on both pools, equal solo generate."""
    m = SumMarker()
    eng = ServingEngine(m, max_slots=2, max_len=16, prefill_buckets=(8,),
                        draft_model=SumMarker(), spec_tokens=3, device="cpu")
    off = eng.submit([1, 2, 3, 4], max_new_tokens=12, spec=False)
    on = eng.submit([5, 6, 7, 8], max_new_tokens=12)
    eng.run_until_drained(timeout=60)
    for r, prompt in ((off, [1, 2, 3, 4]), (on, [5, 6, 7, 8])):
        solo, _ = generate(m, torch.tensor([prompt]), max_new_tokens=12,
                           device="cpu")
        assert r.tokens() == solo[0].tolist()
    tm = models["target"][1]
    for kv in ("fixed", "paged"):
        eng = ServingEngine(tm, max_slots=1, max_len=16, prefill_buckets=(8,),
                            kv=kv, block_size=4, device="cpu",
                            draft_model=models["clone"][1], spec_tokens=3)
        assert eng._pool_len == 19
        r = eng.submit([1, 2, 3, 4], max_new_tokens=12)
        eng.run_until_drained(timeout=60)
        assert r.tokens() == torch_solo(tm, [1, 2, 3, 4], 12)


def test_small_bucket_engine_has_trash_for_every_verify_row(models):
    """3 slots, bucket 8, K = 3: a verify writes 12 rows per call, more
    than the bucket's 8; the trash blocks hold one row for each, so the
    warm-up run (every write dropped) and served traffic work."""
    tm = models["target"][1]
    eng = ServingEngine(tm, max_slots=3, max_len=32, prefill_buckets=(8,),
                        kv="paged", block_size=8, device="cpu",
                        draft_model=models["draft"][1], spec_tokens=3)
    trash = eng._pool_store[0][0].shape[0] - eng.kv_pool.num_blocks
    assert trash * 8 >= 3 * 4
    assert eng._draft_store[0][0].shape[0] == eng._pool_store[0][0].shape[0]
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 128, (n,)) for n in (3, 5, 8, 2)]
    resps = [eng.submit(p, max_new_tokens=12) for p in prompts]
    eng.run_until_drained(timeout=60)
    for p, r in zip(prompts, resps):
        assert r.tokens() == torch_solo(tm, p, 12)


# ---------------------------------------------------------------------------
# preemption and pool pressure with the draft pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["fixed", "paged"])
def test_preempt_restore_carries_the_draft_rows(models, kv):
    """A speculative run preempted after two ticks keeps its target and
    draft rows [0, pos) on the host, and restored into another slot its
    stream and its accept count equal an uninterrupted run's (a noisy
    clone draft: the draft context matters for accepts)."""
    tm, td = models["target"][1], models["noisy"][1]
    prompt = [2, 4, 6]
    kw = dict(max_new_tokens=24, seed=3, **SAMPLED)
    eng = ServingEngine(tm, draft_model=td, kv=kv, device="cpu", **SPEC)
    whole = eng.submit(prompt, **kw)
    eng.run_until_drained(timeout=60)
    clean = _spec_counts(eng)
    eng.reset_metrics()
    assert _spec_counts(eng) == (0, 0, 0)
    r = eng.submit(prompt, **kw)
    eng.step()
    eng.step()
    (slot,) = eng._slots
    paused = eng.preempt_slot(slot)
    assert len(paused.draft_kv_rows) == len(td.gpt.blocks)
    assert paused.draft_kv_rows[0][0].shape[0] == paused.pos
    store = eng._draft_store[0][0]
    if kv == "fixed":
        assert torch.equal(paused.draft_kv_rows[0][0],
                           store[slot, :paused.pos])
    # a spec-off request takes the freed slot meanwhile
    eng.submit([9, 9, 9], max_new_tokens=3, spec=False)
    eng.step()
    assert eng.restore_run(paused)
    eng.run_until_drained(timeout=60)
    assert r.tokens() == whole.tokens()
    assert r.request.preempts == r.request.resumes == 1
    assert _spec_counts(eng)[1:] == clean[1:]


def test_pool_pressure_completes_speculative_runs(models):
    """7 blocks where 14 would back both slots: speculative runs are
    parked and resumed as they grow K+1 = 6 rows a tick (more than the
    decode chunk's 4: the blocks are backed per tick, not per chunk), and
    every stream equals the full pool's, greedy ones solo generate."""
    tm, td = models["target"][1], models["noisy"][1]
    cfg = dict(SPEC, max_slots=2, prefill_buckets=(8,), kv="paged",
               spec_tokens=5)
    traffic = [(4, 30, {}), (3, 30, dict(SAMPLED, seed=5)),
               (6, 28, {}), (5, 26, dict(SAMPLED, seed=7))]
    full = _serve(ServingEngine(tm, draft_model=td, device="cpu", **cfg),
                  traffic, seed=2)
    rng = np.random.RandomState(2)
    for (n, m, kw), toks in zip(traffic, full):
        prompt = rng.randint(0, 128, (n,))
        if not kw:
            assert toks == torch_solo(tm, prompt, m)
    eng = ServingEngine(tm, draft_model=td, device="cpu", num_blocks=7,
                        **cfg)
    assert _serve(eng, traffic, seed=2) == full
    kv = eng.metrics()["kv_pool"]
    assert kv["oom_preempts"] >= 1 and kv["oom_resumes"] == kv["oom_preempts"]
    assert kv["oom_failed"] == 0 and kv["used_blocks"] == 0
    assert eng.post_warmup_compiles() == 0


# ---------------------------------------------------------------------------
# faults and refused configurations
# ---------------------------------------------------------------------------

def test_draft_diverge_collapses_accepts_not_streams(models):
    """Draft logits negated every tick: a clone draft (accept rate 1.0
    clean) is all but always rejected, and the streams stay right."""
    tm = models["target"][1]
    faults.enable("draft_diverge", "1")
    eng = ServingEngine(tm, draft_model=models["clone"][1], kv="paged",
                        device="cpu", **SPEC)
    assert eng._diverge_every == 1
    faults.reset()            # presence was read at construction
    g = eng.submit([1, 2, 3, 4], max_new_tokens=9)
    s = eng.submit([5, 6, 7], max_new_tokens=9, seed=5, **SAMPLED)
    eng.run_until_drained(timeout=60)
    assert g.tokens() == torch_solo(tm, [1, 2, 3, 4], 9)
    assert s.error is None and len(s.tokens()) == 9
    assert eng.metrics()["spec"]["accept_rate"] < 0.2
    assert ServingEngine(tm, draft_model=models["clone"][1],
                         device="cpu", **SPEC)._diverge_every is None


def test_refused_configurations(models):
    tm, td = models["target"][1], models["draft"][1]
    with pytest.raises(InvalidArgumentError, match="prefix_cache"):
        ServingEngine(tm, draft_model=td, kv="paged", prefix_cache=True,
                      device="cpu")
    for k in (0, 48):
        with pytest.raises(InvalidArgumentError, match="spec_tokens"):
            ServingEngine(tm, max_len=48, draft_model=td, spec_tokens=k,
                          device="cpu")
    plain = ServingEngine(tm, max_len=48, device="cpu")
    with pytest.raises(InvalidArgumentError, match="draft_model"):
        plain.submit([1, 2], max_new_tokens=2, spec=True)
    assert plain.metrics()["spec"] == {"enabled": False}
    assert plain.make_request([1, 2], 2)[0].spec is False
