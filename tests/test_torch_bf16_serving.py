"""bf16 serving in paddle_tpu_torch against the JAX package on the CPU.

The reference serves a model decorated to bf16 (``amp.decorate(level=
"O2")``): its paged-attention and int8 kernels take bf16 operands, compute
in f32 inside and write the input's dtype, and its engine takes ``dtype=``
for the KV pools and the prefill scratch.  Here:

- the plain K3 (paged attention) and K4 (int8 dequant-matmul) at bf16
  against the reference's Pallas kernels run through the interpreter;
  both compute in f32 and round once to bf16, so they may differ by the
  rounding of f32 sums taken in another order: one bf16 unit (rtol 8e-3
  > 2**-7, a unit's largest relative size; atol 1e-3);
- one decode step of a tiny bf16 int8 GPT on the port's paged engine
  against the reference's bf16 paged engine, on the same KV state: the
  logits within atol 0.1 + rtol 2e-2.  The two frameworks round the bf16
  activations at other places (layer norm, gelu, the attention's inputs),
  a few bf16 units (2**-8 relative) at |logits| <= 8;
- the port's bf16 fixed engine against solo ``generate``: greedy streams
  equal (both attend in q's dtype, as the reference's ``attend_fixed``);
  its bf16 paged engine attends in f32 (K3, like the reference's paged
  kernel), so at a near tie it may pick another token: each token it
  picks is within LOGITS_TOL of the top logit of the fixed path fed the
  same tokens;
- ``ServingEngine(dtype=None)`` builds f32 pools, as before.

Greedy streams are not compared across the two frameworks in bf16: a
near tie between two logits a few bf16 units apart can flip an argmax.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import models as jmodels
from paddle_tpu.ops import int8_matmul as jim
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.quantization import quantize_for_serving as jquantize
from paddle_tpu.quantization import quantize_weight_int8 as jquant
from paddle_tpu.serving import ServingEngine as JEngine

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import load_paddle_state
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
from paddle_tpu_torch.ops import int8_matmul as tim
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.quantization import quantize_for_serving
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.engine import paged_decode_logits
from paddle_tpu_torch.weights import host_tensor as _tensor

from torch_parity import TINY, jax_state, tiny_pair, torch_solo

BF16_TOL = dict(rtol=8e-3, atol=1e-3)    # one bf16 unit
LOGITS_TOL = dict(rtol=2e-2, atol=1e-1)  # two frameworks' bf16 forwards
ENGINE = dict(max_slots=3, max_len=48, prefill_buckets=(8, 16),
              decode_chunk=4, block_size=8)


def _bf16(a):
    """A numpy f32 array rounded to bf16, as (jax array, torch tensor)
    holding the same values."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


@pytest.fixture
def interpret():
    """The reference's Pallas kernels through the interpreter."""
    jim._INTERPRET = jpa._INTERPRET = True
    yield
    jim._INTERPRET = jpa._INTERPRET = False


@pytest.mark.parametrize("m,k,n", [(5, 32, 128), (16, 64, 256),
                                   (300, 32, 128), (8, 1024, 384)])
def test_dequant_matmul_plain_bf16_matches_pallas(interpret, m, k, n):
    rng = np.random.RandomState(m + k + n)
    jx, tx = _bf16(rng.randn(m, k).astype(np.float32))
    wi, s = jquant(rng.randn(k, n).astype(np.float32))
    want = jim.dequant_matmul(jx, wi, s.reshape(1, -1))
    assert want.dtype == jnp.bfloat16
    got = tim.dequant_matmul(tx, torch.from_numpy(np.array(wi)),
                             torch.from_numpy(np.array(s)).reshape(1, -1))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    torch.testing.assert_close(
        got.float(), torch.from_numpy(np.asarray(want.astype(jnp.float32))),
        **BF16_TOL)


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    ("bfloat16", "bfloat16"), ("float32", "bfloat16"),
    ("bfloat16", "float32")])
def test_paged_attention_plain_bf16_matches_pallas(interpret, q_dtype,
                                                   kv_dtype):
    """Every dtype pair with a bf16 side: q and the pools independently,
    the output in q's dtype; sentinel tails and ragged positions."""
    rng = np.random.RandomState(3)
    nb_pool, bs, h, d = 10, 4, 2, 32
    arrays = {"k": rng.randn(nb_pool, bs, h, d).astype(np.float32),
              "v": rng.randn(nb_pool, bs, h, d).astype(np.float32),
              "q": rng.randn(3, h, d).astype(np.float32)}
    j, t = {}, {}
    for name, a in arrays.items():
        dt = q_dtype if name == "q" else kv_dtype
        if dt == "bfloat16":
            j[name], t[name] = _bf16(a)
        else:
            j[name], t[name] = jnp.asarray(a), torch.from_numpy(a)
    tables = np.array([[7, 2, 9, nb_pool], [1, nb_pool, nb_pool, nb_pool],
                       [3, 4, 5, 6]], np.int32)
    pos = np.array([9, 2, 15], np.int32)
    want = np.stack([np.asarray(jpa.paged_attention(
        j["q"][i], j["k"], j["v"], jnp.asarray(tables[i]),
        int(pos[i])).astype(jnp.float32)) for i in range(3)])
    got = tpa.paged_attention(t["q"], t["k"], t["v"],
                              torch.from_numpy(tables),
                              torch.from_numpy(pos))
    assert got.dtype == t["q"].dtype
    torch.testing.assert_close(got.float(), torch.from_numpy(want),
                               **BF16_TOL)


def _bf16_int8_pair(seed=1):
    """(jax model, port model): the tiny GPT decorated to bf16 (O2), then
    int8 weight-only on both sides, the same weights."""
    paddle.seed(seed)
    jm = jmodels.GPTForPretraining(jmodels.GPTConfig(**TINY))
    jm.eval()
    tm = GPTForPretraining(GPTConfig(**TINY), device="cpu").eval()
    jamp.decorate(models=jm, level="O2", dtype="bfloat16")
    tamp.decorate(models=tm, level="O2", dtype="bfloat16")
    jquantize(jm)
    quantize_for_serving(tm)
    load_paddle_state(tm, jax_state(jm))
    return jm, tm


@pytest.fixture(scope="module")
def bf16_pair():
    return _bf16_int8_pair()


def test_bf16_int8_paged_decode_logits_match_reference(bf16_pair,
                                                       interpret):
    """The reference's bf16 paged engine admits three prompts and decodes
    a chunk; from its KV pools, tables, positions and last tokens, one
    decode step's logits by the port's paged path (K3 and K4's plain
    versions on bf16 operands) against the reference's decode step."""
    jm, tm = bf16_pair
    assert next(tm.parameters()).dtype == torch.bfloat16
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 128, (n,)) for n in (4, 11, 14)]
    jeng = JEngine(jm, kv="paged", dtype=jnp.bfloat16, **ENGINE)
    for p in prompts:
        jeng.submit(p, max_new_tokens=20)
    jeng.step()
    want, pos, toks, tables = [], [], [], []
    for slot in range(len(prompts)):
        run = jeng._slots[slot]
        jeng.kv_pool.ensure(slot, run.pos + 1)   # back the row to write
        table = jeng.kv_pool.table_array(slot)
        ctx = [(jpa.gather_block_rows(kp, jnp.asarray(table))[None],
                jpa.gather_block_rows(vp, jnp.asarray(table))[None])
               for kp, vp in jeng._pools]
        logits, _ = jeng._apply(jeng._state,
                                jnp.asarray([[run.last_token]], jnp.int32),
                                ctx, jnp.asarray(run.pos, jnp.int32))
        want.append(np.asarray(logits[0, -1].astype(jnp.float32)))
        pos.append(run.pos)
        toks.append(run.last_token)
        tables.append(table)
    tables = np.stack(tables)
    pools = [(_tensor(np.asarray(k)), _tensor(np.asarray(v)))
             for k, v in jeng._pools]
    assert pools[0][0].dtype == torch.bfloat16
    with torch.inference_mode():
        got = paged_decode_logits(
            tm, pools, tables, torch.from_numpy(tables),
            np.ones(len(prompts), bool), np.array(pos), torch.tensor(toks),
            jeng.kv_pool.num_blocks, ENGINE["block_size"], ENGINE["max_len"])
    torch.testing.assert_close(got, torch.from_numpy(np.stack(want)),
                               **LOGITS_TOL)


def test_bf16_paged_engine_agrees_with_fixed_engine_and_solo(bf16_pair):
    _, tm = bf16_pair
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 128, (n,)) for n in (4, 7, 11, 14, 5)]
    streams = {}
    for kv in ("paged", "fixed"):
        eng = ServingEngine(tm, kv=kv, dtype=torch.bfloat16, device="cpu",
                            **ENGINE)
        assert all(t.dtype == torch.bfloat16
                   for pair in eng._pools for t in pair)
        rs = [eng.submit(p, max_new_tokens=6 + i)
              for i, p in enumerate(prompts)]
        eng.run_until_drained(timeout=120)
        streams[kv] = [r.tokens(timeout=5) for r in rs]
    assert streams["fixed"] == [torch_solo(tm, p, 6 + i)
                                for i, p in enumerate(prompts)]
    with torch.inference_mode():
        for p, stream, fixed in zip(prompts, streams["paged"],
                                    streams["fixed"]):
            assert len(stream) == len(fixed)
            ids = torch.from_numpy(np.concatenate([p, stream])[None, :-1])
            logits, _ = tm.forward_fixed(
                ids, tm.gen_fixed_cache(1, ids.shape[1], torch.bfloat16), 0)
            rows = logits[0, len(p) - 1:].float()
            top = rows.max(-1).values
            picked = rows[torch.arange(len(stream)), torch.tensor(stream)]
            assert bool((top - picked <= LOGITS_TOL["atol"]
                         + LOGITS_TOL["rtol"] * top.abs()).all())


@pytest.mark.parametrize("kv", ["fixed", "paged"])
def test_engine_dtype_none_builds_f32_pools(kv):
    _, tm = tiny_pair(seed=1)
    eng = ServingEngine(tm, kv=kv, device="cpu", **ENGINE)
    assert all(t.dtype == torch.float32 for pair in eng._pools for t in pair)
    r = eng.submit([1, 2, 3], max_new_tokens=3)
    eng.run_until_drained(timeout=60)
    assert len(r.tokens(timeout=5)) == 3


def test_load_paddle_state_takes_bf16_arrays_bit_for_bit(bf16_pair):
    jm, tm = bf16_pair
    for name, arr in jax_state(jm).items():
        got = tm.state_dict()[name]
        if arr.dtype.name == "bfloat16":
            np.testing.assert_array_equal(
                got.float().numpy(), arr.astype(np.float32))


def test_bf16_speculation_matches_reference_engine(bf16_pair):
    """A bf16-decorated int8 target and draft (a clone: every proposal is
    accepted) on bf16 paged pools, the port's speculative engine against
    the reference's: equal accept counts (all of them), and each greedy
    stream equal to the reference's or split at a near tie — at the first
    split the two tokens' logits on the port's fixed path, fed the common
    prefix, are within LOGITS_TOL of each other."""
    jm, tm = bf16_pair
    jd, td = _bf16_int8_pair()
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 128, (n,)) for n in (4, 9, 14)]
    cfg = dict(ENGINE, kv="paged", spec_tokens=3)
    eng = ServingEngine(tm, dtype=torch.bfloat16, draft_model=td,
                        device="cpu", **cfg)
    assert all(t.dtype == torch.bfloat16
               for store in (eng._pool_store, eng._draft_store)
               for pair in store for t in pair)
    jeng = JEngine(jm, dtype=jnp.bfloat16, draft_model=jd, **cfg)
    streams, specs = [], []
    for e in (eng, jeng):
        rs = [e.submit(p, max_new_tokens=6) for p in prompts]
        e.run_until_drained(timeout=240)
        streams.append([r.tokens(timeout=5) for r in rs])
        specs.append(e.metrics()["spec"])
    assert specs[0]["accepted"] == specs[1]["accepted"] \
        == specs[0]["proposed"] > 0
    assert specs[0]["proposed"] == specs[1]["proposed"]
    with torch.inference_mode():
        for p, got, want in zip(prompts, *streams):
            assert len(got) == len(want) == 6
            split = next((i for i, (a, b) in enumerate(zip(got, want))
                          if a != b), None)
            if split is None:
                continue
            ids = torch.from_numpy(np.concatenate([p, got[:split]])[None])
            logits, _ = tm.forward_fixed(
                ids, tm.gen_fixed_cache(1, ids.shape[1], torch.bfloat16), 0)
            row = logits[0, -1].float()
            top = row.abs().max()
            assert abs(float(row[got[split]] - row[want[split]])) <= (
                LOGITS_TOL["atol"] + LOGITS_TOL["rtol"] * float(top))
