"""Batched multi-adapter LoRA in paddle_tpu_torch against the JAX package
on the CPU (``paddle_tpu_torch.lora``, ``ServingEngine(lora=)``).

The tiny GPT of ``torch_parity`` (2 layers, hidden 64, vocab 128), rank 4
on the four default targets, ``max_adapters`` 3.  Factors are drawn with
numpy from fixed seeds and set by layer path on both sides; the
reference's adapters are exported by the reference and served by the
port.  Held against the reference:

- ``LoRALinear``'s forward and its factors' gradients (f32, 1e-5),
  ``merged_weight``, ``apply_lora``'s freezing (the same trainable names);
- the ``state_dict`` key sets and ``base_weights_hash`` (f32 and int8:
  equal strings), the artifacts both ways (equal tensor shas; the port's
  file read by the reference's ``read_adapter``), ``load_paddle_state`` of
  a LoRA-wrapped reference model;
- the registry: loads, LRU eviction, pinning, the typed errors and the
  rank / target / base-hash refusals, op by op (outcomes and error type
  names equal);
- mixed-adapter greedy and keyed-sampled streams on the fixed and the
  paged engine: token for token;
- the bf16-decorated int8 LoRA engine: a hooked bf16 layer's output is
  f32 in both frameworks, one paged decode step's logits with every
  adapter live within the bf16 serving tolerance.

Within the port: adapter id 0 is bit-equal to an engine without ``lora=``
(streams and summed logprobs equal exactly), preempt / restore keeps the
adapter and a restore after its eviction fails typed, the constructor
refusals, ``swap_weights`` re-pins the base hash (equal to the reference's
``state_hash`` of the new state), ``TrainStep`` moves only the factors, and
the fault hooks (``adapter_corrupt``, ``nan_logits``, ``slow_decode``;
disarmed, the program family is unchanged).
"""
import copy
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import lora as jlora
from paddle_tpu import models as jmodels
from paddle_tpu import nn as jnn
from paddle_tpu.lora.train import state_hash as jstate_hash
from paddle_tpu.quantization import quantize_for_serving as jquantize
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.utils import faults as jfaults

import paddle_tpu_torch as pt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import load_paddle_state
from paddle_tpu_torch import lora
from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.lora import (AdapterExhaustedError,
                                   AdapterIntegrityError,
                                   AdapterNotFoundError, LoRAConfig)
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
from paddle_tpu_torch.quantization import quantize_for_serving
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.engine import (NonFiniteLogitsError,
                                             paged_decode_logits)
from paddle_tpu_torch.utils import faults
from paddle_tpu_torch.weights import host_tensor

from torch_parity import TINY, jax_state, tiny_pair

RANK, MAX_ADAPTERS = 4, 3
ENGINE = dict(max_slots=4, max_len=48, prefill_buckets=(16,),
              decode_chunk=2, block_size=8)
LORA = dict(rank=RANK, max_adapters=MAX_ADAPTERS)
NAMES = ("a1", "a2", "a3")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_TOL = dict(rtol=2e-2, atol=1e-1)  # two frameworks' bf16 forwards
# the mixed batch: (adapter, sampling knobs or None); five requests on four
# slots, so one waits for a slot (continuous batching)
MIX = [(None, None), ("a1", None), ("a2", None),
       ("a1", dict(temperature=0.9, top_k=20, seed=7)),
       ("a3", dict(temperature=1.1, top_p=0.9, seed=8))]
PROMPTS = [[3, 4, 5, 6, 7], [9, 8, 7], [11, 12, 13, 14, 15, 16, 17],
           [3, 4, 5, 6, 7], [20, 21, 22, 23]]
NEW = 10


def _layer(model, path):
    return functools.reduce(getattr, path.split("."), model)


def _factors(paths, seed):
    """{path: (A, B)} f32, drawn from ``seed`` in sorted path order, large
    enough that an adapter's stream leaves the base's."""
    rng = np.random.default_rng(seed)
    out = {}
    for p in sorted(paths):
        lyr_in, lyr_out = _shape(p)
        out[p] = (rng.normal(0, 0.2, (lyr_in, RANK)).astype(np.float32),
                  rng.normal(0, 0.2, (RANK, lyr_out)).astype(np.float32))
    return out


def _shape(path):
    h, f = TINY["hidden_size"], 4 * TINY["hidden_size"]
    return {"qkv": (h, 3 * h), "proj": (h, h), "ffn_in": (h, f),
            "ffn_out": (f, h)}[path.rsplit(".", 1)[-1]]


def _set_ref(jm, factors):
    for p, (a, b) in factors.items():
        lyr = _layer(jm, p)
        lyr.lora_A._data = paddle.to_tensor(a)._data
        lyr.lora_B._data = paddle.to_tensor(b)._data


def _set_port(tm, factors):
    with torch.no_grad():
        for p, (a, b) in factors.items():
            lyr = _layer(tm, p)
            lyr.lora_A.copy_(torch.from_numpy(a))
            lyr.lora_B.copy_(torch.from_numpy(b))


def _ref_model(seed=1):
    paddle.seed(seed)
    jm = jmodels.GPTForPretraining(jmodels.GPTConfig(**TINY))
    jm.eval()
    return jm


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=1)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Three adapters on the seed-1 base, exported by the reference
    (``ref``) and, with the same factors, by the port (``port``)."""
    tmp = tmp_path_factory.mktemp("lora")
    out = {"ref": {}, "port": {}}
    for i, name in enumerate(NAMES):
        jm = _ref_model()
        paths = jlora.apply_lora(jm, rank=RANK)
        factors = _factors(paths, 100 + i)
        _set_ref(jm, factors)
        out["ref"][name] = str(tmp / f"ref_{name}.npz")
        jlora.export_adapter(jm, out["ref"][name])
        _, tm = tiny_pair(seed=1)
        assert sorted(lora.apply_lora(tm, rank=RANK)) == sorted(paths)
        _set_port(tm, factors)
        out["port"][name] = str(tmp / f"port_{name}.npz")
        lora.export_adapter(tm, out["port"][name])
    return out


def _engine(tm, kv, artifact_paths, **kw):
    eng = ServingEngine(copy.deepcopy(tm), kv=kv, device="cpu",
                        lora=LoRAConfig(**LORA), **ENGINE, **kw)
    for name in NAMES:
        eng.load_adapter(name, artifact_paths[name])
    return eng


def _submit_mix(eng, mix=MIX):
    resps = []
    for (adapter, knobs), p in zip(mix, PROMPTS):
        kw = {} if knobs is None else dict(decode_strategy="sampling",
                                           **knobs)
        resps.append(eng.submit(p, NEW, adapter=adapter, **kw))
    return resps


def _decode_inputs(eng):
    """The decode programs' input buffer names."""
    return set((eng._programs or eng._make_programs())["decode"].inputs)


def _drain_ref(eng):
    while eng.has_work():
        eng.step()


@pytest.fixture(scope="module")
def ref_streams(artifacts):
    """The reference LoRA engine's mixed streams, fixed and paged."""
    out = {}
    for kv in ("fixed", "paged"):
        jeng = JEngine(_ref_model(), kv=kv, lora=jlora.LoRAConfig(**LORA),
                       **ENGINE)
        for name in NAMES:
            jeng.load_adapter(name, artifacts["ref"][name])
        resps = _submit_mix(jeng)
        _drain_ref(jeng)
        out[kv] = [r.tokens(timeout=5) for r in resps]
        jeng.close()
    return out


# ---------------------------------------------------------------------------
# train side
# ---------------------------------------------------------------------------

def _linear_pair(seed=3):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.3, (16, 24)).astype(np.float32)
    b = rng.normal(0, 0.3, (24,)).astype(np.float32)
    a = rng.normal(0, 0.3, (16, RANK)).astype(np.float32)
    bb = rng.normal(0, 0.3, (RANK, 24)).astype(np.float32)
    x = rng.normal(0, 1, (5, 16)).astype(np.float32)
    jbase = jnn.Linear(16, 24)
    jbase.weight._data = paddle.to_tensor(w)._data
    jbase.bias._data = paddle.to_tensor(b)._data
    jw = jlora.LoRALinear(jbase, rank=RANK)
    jw.lora_A._data = paddle.to_tensor(a)._data
    jw.lora_B._data = paddle.to_tensor(bb)._data
    tbase = pt.nn.Linear(16, 24, device="cpu")
    tw = lora.LoRALinear(tbase, rank=RANK)
    with torch.no_grad():
        tbase.weight.copy_(torch.from_numpy(w))
        tbase.bias.copy_(torch.from_numpy(b))
        tw.lora_A.copy_(torch.from_numpy(a))
        tw.lora_B.copy_(torch.from_numpy(bb))
    return jw, tw, x


def test_lora_linear_forward_and_factor_grads_match_reference():
    jw, tw, x = _linear_pair()
    jy = jw(paddle.to_tensor(x))
    jy.sum().backward()
    tx = torch.from_numpy(x)
    ty = tw(tx)
    ty.sum().backward()
    torch.testing.assert_close(ty.detach(), torch.from_numpy(jy.numpy()),
                               **F32_TOL)
    for name in ("lora_A", "lora_B"):
        want = np.asarray(getattr(jw, name).grad)
        torch.testing.assert_close(getattr(tw, name).grad,
                                   torch.from_numpy(want), **F32_TOL)
    assert tw.base.weight.grad is None and not tw.base.weight.requires_grad
    assert (tw.rank, tw.alpha, tw.scaling) == (jw.rank, jw.alpha, jw.scaling)


def test_merged_weight_matches_reference_and_the_dense_oracle():
    jw, tw, x = _linear_pair(seed=4)
    got = tw.merged_weight()
    torch.testing.assert_close(got, torch.from_numpy(
        np.asarray(jw.merged_weight())), **F32_TOL)
    dense = torch.from_numpy(x) @ got + tw.base.bias.detach()
    torch.testing.assert_close(tw(torch.from_numpy(x)).detach(), dense,
                               **F32_TOL)
    # a fresh wrap (B = 0) is the base layer bit for bit
    fresh = lora.LoRALinear(copy.deepcopy(tw.base), rank=RANK)
    tx = torch.from_numpy(x)
    assert torch.equal(fresh(tx), tw.base(tx))


def test_apply_lora_freezes_as_the_reference(pair):
    jm, tm = _ref_model(), copy.deepcopy(pair[1])
    jpaths = jlora.apply_lora(jm, rank=RANK)
    tpaths = lora.apply_lora(tm, rank=RANK)
    assert tpaths == jpaths
    jtrain = sorted(n for n, p in jm.named_parameters() if p.trainable)
    ttrain = sorted(n for n, p in tm.named_parameters() if p.requires_grad)
    assert ttrain == jtrain and all("lora_" in n for n in ttrain)
    assert lora.lora_keys(tm) == jlora.lora_keys(jm)
    wrapper = lora.LoRAWrapper(copy.deepcopy(pair[1]), rank=RANK)
    assert len(wrapper.trainable_parameters()) == 2 * len(tpaths)


@pytest.mark.parametrize("kind", ["f32", "int8", "lora"])
def test_state_dict_keys_equal_reference(kind):
    """The hash runs over these keys: a buffer only one side had would
    change it."""
    jm, tm = tiny_pair(seed=1, quantize=kind == "int8")
    if kind == "lora":
        jlora.apply_lora(jm, rank=RANK)
        lora.apply_lora(tm, rank=RANK)
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_base_weights_hash_equals_reference(quantize):
    jm, tm = tiny_pair(seed=1, quantize=quantize)
    want = jlora.base_weights_hash(jm)
    assert lora.base_weights_hash(tm) == want
    # a wrapped model hashes as its base, on both sides
    jlora.apply_lora(jm, rank=RANK)
    lora.apply_lora(tm, rank=RANK)
    assert lora.base_weights_hash(tm) == jlora.base_weights_hash(jm) == want


def test_artifacts_cross_both_ways(artifacts, pair):
    for name in NAMES:
        jh, jf, _ = jlora.read_adapter(artifacts["ref"][name])
        th, tf, _ = lora.read_adapter(artifacts["ref"][name])
        assert th == jh
        ph, pf, _ = jlora.read_adapter(artifacts["port"][name])
        assert ph["tensor_sha"] == jh["tensor_sha"]
        assert ph == jh     # the header's json is the reference's
        for k in jf:
            for got, want in zip(tf[k] + pf[k], jf[k] + jf[k]):
                np.testing.assert_array_equal(got, want)
    # the train-side restore of a reference artifact into a wrapped port
    # model, then its forward against the reference's
    jm = _ref_model()
    jlora.apply_lora(jm, rank=RANK)
    jlora.load_adapter(jm, artifacts["ref"]["a1"])
    tm = copy.deepcopy(pair[1])
    lora.apply_lora(tm, rank=RANK)
    lora.load_adapter(tm, artifacts["ref"]["a1"])
    ids = np.arange(1, 9, dtype=np.int64)[None]
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    torch.testing.assert_close(got, torch.from_numpy(want), rtol=1e-4,
                               atol=1e-4)


def test_load_paddle_state_takes_a_lora_wrapped_reference_state(artifacts):
    """``….base.weight`` / ``….lora_A`` / ``….lora_B`` by name into an
    ``apply_lora``'d port model."""
    jm = _ref_model()
    jlora.apply_lora(jm, rank=RANK)
    jlora.load_adapter(jm, artifacts["ref"]["a2"])
    tm = GPTForPretraining(GPTConfig(**TINY), device="cpu", seed=9).eval()
    lora.apply_lora(tm, rank=RANK)
    load_paddle_state(tm, jax_state(jm))
    ids = np.arange(2, 12, dtype=np.int64)[None]
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    torch.testing.assert_close(got, torch.from_numpy(np.asarray(
        jm(paddle.to_tensor(ids)).numpy())), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the registry, op by op against the reference's
# ---------------------------------------------------------------------------

def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the type is the outcome
        return ("err", type(e).__name__)


def _registries(pair, cfg_kw, base_sha=None):
    jm, tm = _ref_model(), copy.deepcopy(pair[1])
    targets = cfg_kw.get("targets", lora.DEFAULT_TARGETS)
    jshapes = jlora.attach_serving_lora(jm, targets)
    tshapes = lora.attach_serving_lora(tm, targets)
    assert tshapes == jshapes
    jsha = jlora.base_weights_hash(jm) if base_sha is None else base_sha
    tsha = lora.base_weights_hash(tm) if base_sha is None else base_sha
    assert tsha == jsha
    return (jlora.AdapterRegistry(jlora.LoRAConfig(**cfg_kw), jshapes,
                                  base_sha=jsha),
            lora.AdapterRegistry(LoRAConfig(**cfg_kw), tshapes,
                                 base_sha=tsha, device="cpu"))


def test_registry_lifecycle_matches_reference(pair, artifacts):
    regs = _registries(pair, dict(rank=RANK, max_adapters=2))
    paths = artifacts["ref"]
    results = []
    for reg in regs:
        ops = [lambda: reg.resolve(None), lambda: reg.acquire(""),
               lambda: reg.register("a1", paths["a1"]),
               lambda: reg.register("a2", paths["a2"]),
               lambda: reg.register("a1", paths["a1"]),   # same bytes
               lambda: reg.acquire("a1"),
               lambda: reg.register("a3", paths["a3"]),   # evicts a2
               lambda: reg.resolve("a2"),
               lambda: reg.acquire("a3"),
               lambda: reg.register("a2", paths["a2"]),   # all pinned
               lambda: reg.release(1),
               lambda: reg.register("a2", paths["a2"]),   # evicts a1
               lambda: reg.resolve("a1"),
               lambda: reg.register("", paths["a1"]),
               lambda: sorted(reg.loaded().items()),
               lambda: {k: v for k, v in reg.stats().items()
                        if k != "shas"}]
        results.append([_outcome(op) for op in ops])
    assert results[1] == results[0]
    assert ("err", "AdapterNotFoundError") in results[1]
    assert ("err", "AdapterExhaustedError") in results[1]
    assert issubclass(AdapterNotFoundError, pt.core.errors.NotFoundError)
    assert issubclass(AdapterExhaustedError,
                      pt.core.errors.ResourceExhaustedError)


@pytest.mark.parametrize("case", ["rank", "targets", "base", "truncated"])
def test_registry_refusals_match_reference(pair, artifacts, tmp_path, case):
    cfg = dict(rank=RANK, max_adapters=MAX_ADAPTERS)
    path, base = artifacts["ref"]["a1"], None
    if case == "rank":
        cfg["rank"] = 8
    elif case == "targets":
        cfg["targets"] = ("qkv",)
    elif case == "base":
        base = "deadbeef" * 8
    else:
        raw = open(path, "rb").read()
        path = str(tmp_path / "trunc.npz")
        open(path, "wb").write(raw[:len(raw) // 2])
    jreg, treg = _registries(pair, cfg, base)
    want = _outcome(lambda: jreg.register("a1", path))
    assert want[0] == "err"
    assert _outcome(lambda: treg.register("a1", path)) == want
    assert treg.loaded() == {} and treg.stats()["loads"] == 0


def test_lora_config_spec_round_trip():
    cfg = LoRAConfig(rank=4, max_adapters=2, targets=("qkv",),
                     check_base_hash=False, base_sha="ab")
    assert cfg.spec() == jlora.LoRAConfig(
        rank=4, max_adapters=2, targets=("qkv",), check_base_hash=False,
        base_sha="ab").spec()
    assert LoRAConfig.from_spec(cfg.spec()).spec() == cfg.spec()
    with pytest.raises(InvalidArgumentError):
        LoRAConfig(rank=0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["fixed", "paged"])
def test_mixed_adapter_streams_equal_reference(pair, artifacts, ref_streams,
                                               kv):
    eng = _engine(pair[1], kv, artifacts["ref"])
    warm = eng.warmup()["compile_counts"]
    resps = _submit_mix(eng)
    eng.run_until_drained(timeout=120)
    got = [r.tokens(timeout=5) for r in resps]
    assert got == ref_streams[kv]
    assert len({tuple(s) for s in got[:3]}) == 3   # adapters act
    assert warm["total"] == warm["bound"] and eng.post_warmup_compiles() == 0
    m = eng.metrics()["lora"]
    assert m["loaded"] == 3 and m["pinned"] == 0
    assert eng.adapter_shas() == {n: eng._lora_reg.file_sha(i + 1)
                                  for i, n in enumerate(NAMES)}


@pytest.mark.parametrize("kv", ["fixed", "paged"])
def test_adapter_zero_is_bit_equal_to_no_lora(pair, artifacts, kv):
    """Base requests in a batch with adapters: the same tokens and the
    same summed logprobs, bit for bit, as an engine without ``lora=``
    (the other slots' tokens differ, which a row's bits do not see)."""
    eng = _engine(pair[1], kv, artifacts["ref"])
    plain = ServingEngine(copy.deepcopy(pair[1]), kv=kv, device="cpu",
                          **ENGINE)
    base = [(None, k) for _, k in MIX]
    got = _submit_mix(eng, [(a if i % 2 else None, k)
                            for i, (a, k) in enumerate(MIX)])
    want = _submit_mix(plain, base)
    eng.run_until_drained(timeout=120)
    plain.run_until_drained(timeout=120)
    for i in range(0, len(MIX), 2):
        assert got[i].tokens(timeout=5) == want[i].tokens(timeout=5)
        assert got[i].logprob == want[i].logprob
    assert got[1].tokens(timeout=5) != want[1].tokens(timeout=5)
    assert eng.compile_counts() == plain.compile_counts()


def test_bf16_lora_engine_promotes_to_f32_as_the_reference(artifacts):
    """The bf16-decorated int8 model: the reference's paged LoRA engine
    admits three prompts (base, a1, a2) and decodes a chunk; one decode
    step's logits per slot under its adapter by the reference against the
    port's paged path on the same KV state with every adapter live."""
    paddle.seed(1)
    jm = jmodels.GPTForPretraining(jmodels.GPTConfig(**TINY))
    jm.eval()
    tm = GPTForPretraining(GPTConfig(**TINY), device="cpu").eval()
    jamp.decorate(models=jm, level="O2", dtype="bfloat16")
    tamp.decorate(models=tm, level="O2", dtype="bfloat16")
    jquantize(jm)
    quantize_for_serving(tm)
    load_paddle_state(tm, jax_state(jm))
    cfg = dict(LORA, check_base_hash=False)
    jeng = JEngine(jm, kv="paged", dtype=jnp.bfloat16,
                   lora=jlora.LoRAConfig(**cfg), **ENGINE)
    teng = ServingEngine(tm, kv="paged", dtype=torch.bfloat16, device="cpu",
                         lora=LoRAConfig(**cfg), **ENGINE)
    for name in NAMES:
        jeng.load_adapter(name, artifacts["ref"][name])
        teng.load_adapter(name, artifacts["ref"][name])
    adapters = (None, "a1", "a2")
    for p, a in zip(PROMPTS, adapters):
        jeng.submit(p, max_new_tokens=20, adapter=a)
    jeng.step()
    want, pos, toks, tables, aids = [], [], [], [], []
    for slot in range(len(adapters)):
        run = jeng._slots[slot]
        jeng.kv_pool.ensure(slot, run.pos + 1)
        table = jeng.kv_pool.table_array(slot)
        ctx = [(jlora_gather(kp, table), jlora_gather(vp, table))
               for kp, vp in jeng._pools]
        with jeng._lora_ctx(jeng._lora_reg.device_args(),
                            jnp.int32(run.aid)):
            logits, _ = jeng._apply(
                jeng._state, jnp.asarray([[run.last_token]], jnp.int32), ctx,
                jnp.asarray(run.pos, jnp.int32))
        assert logits.dtype == jnp.float32      # bf16 + f32 delta
        want.append(np.asarray(logits[0, -1]))
        pos.append(run.pos)
        toks.append(run.last_token)
        tables.append(table)
        aids.append(run.aid)
    tables = np.stack(tables)
    pools = [(host_tensor(np.asarray(k)), host_tensor(np.asarray(v)))
             for k, v in jeng._pools]
    reg = teng._lora_reg
    seen = []
    # the engine serves (and hooked) its own copy of the model
    served = teng.model
    hook = served.gpt.blocks[0].qkv.register_forward_hook(
        lambda m, i, o: seen.append((i[0].dtype, o.dtype)))
    with torch.inference_mode(), lora.adapter_context(
            reg.stacks, reg.scales, torch.tensor(aids, dtype=torch.int32)):
        got = paged_decode_logits(
            served, pools, tables, torch.from_numpy(tables),
            np.ones(len(aids), bool), np.array(pos), torch.tensor(toks),
            jeng.kv_pool.num_blocks, ENGINE["block_size"], ENGINE["max_len"])
    hook.remove()
    assert seen == [(torch.bfloat16, torch.float32)]
    torch.testing.assert_close(got, torch.from_numpy(np.stack(want)),
                               **LOGITS_TOL)
    jeng.close()
    # the port's bf16 LoRA engine serves the mix end to end
    resps = _submit_mix(teng)
    teng.run_until_drained(timeout=120)
    assert all(len(r.tokens(timeout=5)) == NEW for r in resps)


def jlora_gather(pool, table):
    from paddle_tpu.ops import paged_attention as jpa
    return jpa.gather_block_rows(pool, jnp.asarray(table))[None]


@pytest.mark.parametrize("kv", ["fixed", "paged"])
def test_preempt_and_restore_keep_the_adapter(pair, artifacts, kv):
    eng = _engine(pair[1], kv, artifacts["ref"])
    solo = eng.submit(PROMPTS[1], 16, adapter="a2")
    eng.run_until_drained(timeout=60)
    want = solo.tokens(timeout=5)
    resp = eng.submit(PROMPTS[1], 16, adapter="a2")
    eng.step()
    eng.step()
    slot = next(iter(eng._slots))
    assert eng.metrics()["lora"]["pinned"] == 1
    paused = eng.preempt_slot(slot)
    assert eng.metrics()["lora"]["pinned"] == 0
    assert eng.restore_run(paused)
    assert eng.metrics()["lora"]["pinned"] == 1
    eng.run_until_drained(timeout=60)
    assert resp.tokens(timeout=5) == want
    assert eng.metrics()["lora"]["pinned"] == 0


def test_restore_after_eviction_fails_typed(pair, artifacts):
    eng = _engine(pair[1], "paged", artifacts["ref"])
    resp = eng.submit(PROMPTS[0], 16, adapter="a1")
    eng.step()
    paused = eng.preempt_slot(next(iter(eng._slots)))
    for i, name in enumerate(("x1", "x2", "x3")):   # evict a1, a2, a3
        eng.load_adapter(name, artifacts["port"][NAMES[i]])
    assert sorted(eng._lora_reg.loaded()) == ["x1", "x2", "x3"]
    free = eng.kv_pool.free_blocks()
    assert eng.restore_run(paused) is True
    with pytest.raises(AdapterNotFoundError):
        resp.tokens(timeout=5)
    assert not eng._slots and eng.kv_pool.free_blocks() == free
    assert eng.metrics()["requests_errored"] == 1
    with pytest.raises(AdapterNotFoundError, match="a1"):
        eng.submit(PROMPTS[0], 4, adapter="a1")


@pytest.mark.parametrize("knob", ["draft_model", "prefix_cache"])
def test_constructor_refusals_name_both_knobs(pair, knob):
    kw = ({"draft_model": tiny_pair(seed=3)[1]} if knob == "draft_model"
          else {"prefix_cache": True})
    with pytest.raises(InvalidArgumentError) as ei:
        ServingEngine(copy.deepcopy(pair[1]), kv="paged", device="cpu",
                      lora=LoRAConfig(**LORA), **ENGINE, **kw)
    assert "lora" in str(ei.value) and knob in str(ei.value)


def test_adapter_requests_are_checked_at_submission(pair, artifacts):
    plain = ServingEngine(copy.deepcopy(pair[1]), device="cpu", **ENGINE)
    with pytest.raises(InvalidArgumentError, match="lora"):
        plain.submit(PROMPTS[0], 4, adapter="a1")
    with pytest.raises(InvalidArgumentError, match="lora"):
        plain.load_adapter("a1", artifacts["ref"]["a1"])
    assert plain.adapter_shas() is None
    assert plain.metrics()["lora"] is None
    eng = _engine(pair[1], "fixed", artifacts["ref"])
    with pytest.raises(AdapterNotFoundError, match="ghost"):
        eng.make_request(PROMPTS[0], 4, adapter="ghost")
    # a second engine on a hooked model is refused, as the reference
    with pytest.raises(ValueError, match="already"):
        ServingEngine(eng.model, device="cpu", lora=LoRAConfig(**LORA),
                      **ENGINE)


def test_swap_weights_repins_the_base_hash(pair, artifacts):
    jm_new, _ = tiny_pair(seed=2)
    eng = _engine(pair[1], "fixed", artifacts["ref"])
    before = _submit_mix(eng)
    eng.run_until_drained(timeout=60)
    old_sha = eng._lora_reg.base_sha
    new_state = jax_state(jm_new)
    eng.swap_weights(new_state, weights_sha="v2")
    assert eng._lora_reg.base_sha == jstate_hash(new_state) != old_sha
    assert eng.metrics()["lora"]["loaded"] == 3      # adapters stay
    after = _submit_mix(eng)
    eng.run_until_drained(timeout=60)
    assert [r.tokens(timeout=5) for r in after] != \
        [r.tokens(timeout=5) for r in before]
    # an artifact trained on the old base is now refused
    with pytest.raises(AdapterIntegrityError, match="base"):
        eng.load_adapter("x1", artifacts["port"]["a1"])
    assert eng.post_warmup_compiles() == 0


def test_train_step_moves_only_the_factors(pair):
    """``TrainStep`` takes as trainable what requires a gradient: after
    ``apply_lora`` only the factors, which move, while every base tensor
    stays bit for bit."""
    tm = copy.deepcopy(pair[1])
    lora.apply_lora(tm, rank=RANK)
    tm.train()
    base = {k: t.clone() for k, t in tm.state_dict().items()
            if "lora_" not in k}
    params = [p for p in tm.parameters() if p.requires_grad]
    step = pt.jit.TrainStep(
        tm, lambda logits, y: torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), y.reshape(-1)),
        pt.optimizer.AdamW(1e-2, parameters=params))
    assert sorted(step._trainable) == sorted(
        k for k in tm.state_dict() if "lora_" in k)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 128, (2, 16)))
    labels = torch.from_numpy(rng.randint(0, 128, (2, 16)))
    b_before = {k: t.clone() for k, t in tm.state_dict().items()
                if k.endswith("lora_B")}
    losses = [float(step(ids, labels)) for _ in range(2)]
    assert all(np.isfinite(losses))
    for k, t in tm.state_dict().items():
        if k in base:
            assert torch.equal(t, base[k]), k
        elif k.endswith("lora_B"):
            assert not torch.equal(t, b_before[k]), k


# ---------------------------------------------------------------------------
# fault hooks
# ---------------------------------------------------------------------------

@pytest.fixture
def clean_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def test_adapter_corrupt_is_typed_and_the_retry_loads(pair, artifacts,
                                                      clean_faults):
    eng = ServingEngine(copy.deepcopy(pair[1]), device="cpu",
                        lora=LoRAConfig(**LORA), **ENGINE)
    jfaults.enable("adapter_corrupt", "2")   # the reference's arms both
    path = artifacts["ref"]["a1"]
    assert eng.load_adapter("a1", path)          # read 1: clean
    with pytest.raises(AdapterIntegrityError):
        eng.load_adapter("a2", artifacts["ref"]["a2"])   # read 2: poisoned
    assert sorted(eng._lora_reg.loaded()) == ["a1"]
    assert eng.load_adapter("a2", artifacts["ref"]["a2"])   # the retry
    assert sorted(eng._lora_reg.loaded()) == ["a1", "a2"]
    raw = open(path, "rb").read()
    faults.reset()
    faults.enable("adapter_corrupt", "1")
    bad = faults.maybe_corrupt_adapter_read(raw)
    assert bad != raw and len(bad) == len(raw)
    assert faults.maybe_corrupt_adapter_read(raw) == raw


@pytest.mark.parametrize("kv", ["fixed", "paged"])
def test_nan_logits_fails_only_the_poisoned_request(pair, artifacts, kv,
                                                    clean_faults):
    clean = _engine(pair[1], kv, artifacts["ref"])
    want = _submit_mix(clean)
    clean.run_until_drained(timeout=120)
    faults.enable("nan_logits", "1")
    eng = _engine(pair[1], kv, artifacts["ref"])
    assert "poison" in _decode_inputs(eng)
    got = _submit_mix(eng)
    eng.run_until_drained(timeout=120)
    with pytest.raises(NonFiniteLogitsError):
        got[1].tokens(timeout=5)
    for i in (0, 2, 3, 4):
        assert got[i].tokens(timeout=5) == want[i].tokens(timeout=5)
    assert eng.metrics()["requests_errored"] == 1
    assert eng.compile_counts() == clean.compile_counts()


def test_slow_decode_sleeps_on_its_stride(pair, monkeypatch, clean_faults):
    slept = []
    monkeypatch.setattr(faults.time, "sleep", slept.append)
    eng = ServingEngine(copy.deepcopy(pair[1]), device="cpu", **ENGINE)
    faults.enable("slow_decode", "25:3")
    eng.submit(PROMPTS[0], 11)       # 10 decode tokens: 5 decode calls
    eng.run_until_drained(timeout=60)
    assert eng._decode_calls == 5
    assert slept == [0.025, 0.025]   # calls 0 and 3
    assert faults.slow_decode_config() == jfaults.slow_decode_config()
    faults.disable("slow_decode")
    assert faults.maybe_slow_decode(0) == 0.0


@pytest.mark.parametrize("kv", ["fixed", "paged"])
def test_disarmed_faults_leave_the_program_family(pair, kv, clean_faults):
    eng = ServingEngine(copy.deepcopy(pair[1]), kv=kv, device="cpu",
                        **ENGINE)
    counts = eng.warmup()["compile_counts"]
    base = {"tokens", "pos", "keys", "temp", "top_k", "top_p", "greedy"}
    if kv == "paged":
        base |= {"tables", "active"}
    assert set(_decode_inputs(eng)) == base
    assert counts["total"] == counts["bound"] == len(ENGINE[
        "prefill_buckets"]) + 2
    leng = ServingEngine(copy.deepcopy(pair[1]), kv=kv, device="cpu",
                         lora=LoRAConfig(**LORA), **ENGINE)
    assert set(_decode_inputs(leng)) == base | {"aids"}
    assert leng.warmup()["compile_counts"] == counts


@pytest.mark.parametrize("kv", ["fixed", "paged"])
def test_lora_programs_read_nothing_on_the_host(pair, artifacts, kv,
                                                monkeypatch, clean_faults):
    """The adapter gathers and the poison mask stay on the device: the
    prefill and both decode programs of a LoRA engine with nan_logits
    armed run with every host read refused (a capture would break on
    one)."""
    from test_torch_serving_programs import _no_host_reads
    faults.enable("nan_logits", "99")
    eng = _engine(pair[1], kv, artifacts["ref"])
    _submit_mix(eng)
    eng.step()
    with torch.inference_mode():
        eng._rebuild_batch()
        if kv == "paged":
            eng._sync_tables(True)
        assert int(eng._programs["decode"].inputs["aids"].max()) > 0
        with monkeypatch.context() as m:
            _no_host_reads(m)
            out = {name: eng._programs[name].run()
                   for name in ("decode", "decode_greedy", 16)}
    assert bool(out["decode"][2].all())
    assert out[16][0].shape == (1,)
