"""``ServingEngine.swap_weights`` of paddle_tpu_torch on the CPU.

The tiny GPT of ``torch_parity`` (f32 and int8), two weight draws carried
from the JAX package by name (``jax_state``: the reference's state keys,
numpy arrays, as a published checkpoint holds them):

- After a swap the engine's streams equal a fresh engine's on the new
  weights and solo ``generate`` (token equality), nothing is made after
  warmup, every parameter and buffer of the engine's own copy of the
  model keeps its storage (written in place, so the programs captured on
  it read the new weights), the prefix cache is flushed,
  ``refresh_epoch`` / ``weights_sha`` move.
- The model the engine was built on, and another engine built on the
  same model, are left alone, as the reference's engine (which swaps its
  own state dict) leaves them.
- A missing or unexpected key or a wrong shape raises
  InvalidArgumentError before anything is written: the old weights are
  still served.
- Another dtype is cast to the served one, as the reference casts: an f64
  copy of a state (its values exactly representable, so the cast is exact)
  serves the same streams as the state itself.
- On a speculative engine the target swaps and the draft stays.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import ServingEngine as JEngine

from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.serving import ServingEngine

from torch_parity import jax_state, tiny_pair, torch_solo

ENGINE = dict(max_slots=3, max_len=48, prefill_buckets=(8, 32), block_size=8,
              kv="paged")
PREFIX = list(range(3, 19))          # two full blocks: cached, then hit
PROMPTS = [PREFIX + [40, 41], PREFIX + [50], [7, 8, 9]]


def _serve(engine, prompts=PROMPTS, max_new=10):
    resps = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    engine.run_until_drained(timeout=120)
    return [r.tokens(timeout=5) for r in resps]


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "int8"])
def weights(request):
    return (tiny_pair(seed=1, quantize=request.param),
            tiny_pair(seed=2, quantize=request.param))


@pytest.fixture
def pairs(weights):
    """The two draws: ((jax model, port model), (jax new, port new))."""
    return weights


def test_swap_serves_the_new_weights_in_place(pairs):
    (_, tm), (jm_new, tm_new) = pairs
    eng = ServingEngine(tm, prefix_cache=True, device="cpu", **ENGINE)
    old = _serve(eng)
    assert eng.prefix_cache.hits > 0
    served = eng.model.state_dict()
    ptrs = {k: t.data_ptr() for k, t in served.items()}
    warm = eng.compile_counts()
    eng.swap_weights(jax_state(jm_new), weights_sha="sha-2")
    assert eng.prefix_cache.stats()["nodes"] == 0
    assert (eng.refresh_epoch, eng.weights_sha) == (1, "sha-2")
    assert {k: t.data_ptr() for k, t in served.items()} == ptrs
    for k, t in tm_new.state_dict().items():
        assert torch.equal(served[k], t), k
    got = _serve(eng)
    fresh = ServingEngine(tm_new, prefix_cache=True, device="cpu", **ENGINE)
    assert got == _serve(fresh) != old
    assert got == [torch_solo(tm_new, p, 10) for p in PROMPTS]
    assert eng.compile_counts() == warm and eng.post_warmup_compiles() == 0


def _bad_states(state):
    """Each state is wrong in one leaf, the LAST in the model's order, so
    a swap that wrote while it checked would have written every other."""
    last = list(state)[-1]
    arr = state[last]
    missing = dict(state)
    del missing[last]
    shape = dict(state, **{last: np.zeros(arr.shape + (1,), arr.dtype)})
    extra = dict(state, extra=np.zeros((1,), np.float32))
    return {"missing": missing, "unexpected": extra, "shape": shape}


def test_a_mismatch_raises_and_writes_nothing(pairs):
    (_, tm), (jm_new, _) = pairs
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    before = _serve(eng)
    kept = {k: t.clone() for k, t in eng.model.state_dict().items()}
    new = jax_state(jm_new)
    for name, state in _bad_states(new).items():
        with pytest.raises(InvalidArgumentError):
            eng.swap_weights(state)
        for k, t in eng.model.state_dict().items():
            assert torch.equal(t, kept[k]), (name, k)
    assert eng.refresh_epoch == 0
    assert _serve(eng) == before


def test_another_dtype_is_cast_to_the_served_one(pairs):
    """Every leaf as f64 (int8 buffers too): cast on the staged copy, then
    written in place; the streams equal the f32 state's."""
    (_, tm), (jm_new, tm_new) = pairs
    new = jax_state(jm_new)
    wide = {k: np.asarray(v).astype(np.float64) for k, v in new.items()}
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    _serve(eng)
    served = eng.model.state_dict()
    ptrs = {k: t.data_ptr() for k, t in served.items()}
    dtypes = {k: t.dtype for k, t in served.items()}
    eng.swap_weights(wide)
    assert {k: t.data_ptr() for k, t in served.items()} == ptrs
    assert {k: t.dtype for k, t in served.items()} == dtypes
    for k, t in tm_new.state_dict().items():
        assert torch.equal(served[k], t), k
    assert _serve(eng) == [torch_solo(tm_new, p, 10) for p in PROMPTS]
    assert eng.refresh_epoch == 1 and eng.post_warmup_compiles() == 0


def test_speculative_engine_swaps_the_target_only(pairs):
    """Tensors are taken as well as arrays; the draft keeps its weights
    and greedy streams follow the new target (speculation never changes a
    greedy stream)."""
    (_, tm), (_, tm_new) = pairs
    _, draft = tiny_pair(seed=3)
    eng = ServingEngine(tm, draft_model=draft, spec_tokens=3, device="cpu",
                        **ENGINE)
    _serve(eng)
    drafted = {k: t.clone() for k, t in eng.draft_model.state_dict().items()}
    eng.swap_weights({k: t.clone() for k, t in tm_new.state_dict().items()})
    for k, t in eng.draft_model.state_dict().items():
        assert torch.equal(t, drafted[k]), k
    assert _serve(eng) == [torch_solo(tm_new, p, 10) for p in PROMPTS]
    assert eng.post_warmup_compiles() == 0


PEER = dict(max_slots=2, max_len=48, kv="paged")


def test_swap_leaves_the_model_and_peer_engines_alone(pairs):
    """Two engines over one model in each framework; the first of each
    pair swaps to the second draw.  The second engine's streams and the
    model's tensors stay as they were, as the reference's stay; the
    swapped engine serves a fresh engine's streams on the new weights."""
    (jm, tm), (jm_new, tm_new) = pairs
    prompts = [[7, 8, 9]] + PROMPTS[:2]
    kept = {k: t.clone() for k, t in tm.state_dict().items()}
    jkept = jax_state(jm)
    a, b = (ServingEngine(tm, device="cpu", **PEER) for _ in range(2))
    ja, jb = (JEngine(jm, **PEER) for _ in range(2))
    before, jbefore = _serve(b, prompts), _serve(jb, prompts)
    assert before == jbefore
    new = jax_state(jm_new)
    a.swap_weights(new, weights_sha="sha-2")
    ja.swap_weights(new, "sha-2")
    assert _serve(b, prompts) == before
    assert _serve(jb, prompts) == jbefore
    for k, t in tm.state_dict().items():
        assert torch.equal(t, kept[k]), k
    for k, v in jax_state(jm).items():
        assert np.array_equal(v, jkept[k]), k
    fresh = ServingEngine(tm_new, device="cpu", **PEER)
    got = _serve(a, prompts)
    assert got == _serve(fresh, prompts) == _serve(ja, prompts) != before
    assert a.post_warmup_compiles() == 0
    assert b.weights_sha is None and b.refresh_epoch == 0
