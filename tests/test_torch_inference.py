"""paddle_tpu_torch's inference front against the JAX package's on the CPU.

- ``jit.save`` writes the reference's npz (keys and values) and metadata
  (``input_spec``, ``op_versions``); ``jit.load`` + ``Predictor.run`` of a
  small MLP and of a 2-layer BERT classifier (ids and the padding mask as
  inputs, the flash route: K1's operator, its plain version here) are
  within 1e-5 of the reference's ``TranslatedLayer`` on the same weights
  and inputs; the op-version compatibility cases of the reference's tests
  hold; a reference ``.pdmodel`` is refused, typed.
- ``create_predictor(Config(prefix).enable_serving(model_provider=...))``
  served from a REFERENCE ``jit.save`` npz gives the reference
  predictor's streams, with and without ``quantize="int8"`` (the int8 one
  behind a gateway), and ``profile_report()`` has the reference's keys.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu import models as jmodels
from paddle_tpu.jit import state_arrays

import paddle_tpu_torch as pt
from paddle_tpu_torch import jit, models as tmodels, nn as tnn
from paddle_tpu_torch.core.errors import UnavailableError, UnimplementedError
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.serving import PRIORITY_HIGH, TenantConfig
from paddle_tpu_torch.utils import op_version

from torch_parity import TINY

torch.set_num_threads(1)

S = 128
BERT = dict(vocab_size=64, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=256,
            max_position_embeddings=S, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
SERVE = dict(max_slots=2, max_len=48, prefill_buckets=(8, 16),
             decode_chunk=2, kv="paged", block_size=8)


def _np_state(model):
    return {k: np.asarray(v) for k, v in state_arrays(model).items()}


class JClassifier(paddle.nn.Layer):
    """A BERT sequence classifier taking (ids, padding mask)."""

    def __init__(self):
        super().__init__()
        self.model = jmodels.BertForSequenceClassification(
            jmodels.BertConfig(**BERT), num_classes=2)

    def forward(self, ids, mask):
        return self.model(ids, attention_mask=mask)


class TClassifier(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.model = tmodels.BertForSequenceClassification(
            tmodels.BertConfig(**BERT), num_classes=2, device="cpu")

    def forward(self, ids, mask):
        return self.model(ids, attention_mask=mask)


JClassifier.__name__ = TClassifier.__name__ = "Classifier"


def _mlps():
    paddle.seed(0)
    j = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                             paddle.nn.Linear(16, 4))
    t = tnn.Sequential(tnn.Linear(8, 16, device="cpu"), tnn.ReLU(),
                       tnn.Linear(16, 4, device="cpu"))
    return j, t


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Reference and port artifacts of the MLP and the classifier, one
    weight set each."""
    d = tmp_path_factory.mktemp("artifacts")
    out = {}
    for name, make, (shape, dtype, n) in (
            ("mlp", _mlps, ([-1, 8], "float32", 1)),
            ("bert", lambda: (JClassifier(), TClassifier()),
             ([-1, S], "int64", 2))):
        paddle.seed(3)
        jm, tm = make()
        jm.eval()
        pt.load_paddle_state(tm, _np_state(jm))
        tm.eval()
        jp, tp = str(d / f"ref_{name}"), str(d / f"port_{name}")
        paddle.jit.save(jm, jp, input_spec=[
            paddle.static.InputSpec(shape, dtype)] * n)
        jit.save(tm, tp, input_spec=[jit.InputSpec(shape, dtype)] * n)
        out[name] = (jm, tm, jp, tp)
    return out


def _meta(path):
    with open(path + ".pdmeta", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("name", ["mlp", "bert"])
def test_jit_save_writes_the_reference_npz_and_meta(saved, name):
    _, _, jp, tp = saved[name]
    with np.load(jp + ".pdiparams.npz") as a, \
            np.load(tp + ".pdiparams.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    ours, theirs = _meta(tp), _meta(jp)
    for key in ("class", "op_versions"):
        assert ours[key] == theirs[key], key
    assert "export_error" not in ours and "export_fallback" not in ours
    if name == "bert":
        # the reference's symbolic export of BERT fails and falls back to
        # concrete shapes (every -1 = 1); the port's stays symbolic
        assert "export_fallback" in theirs
        assert [((1,) + s[1:], d) for s, d in ours["input_spec"]] \
            == theirs["input_spec"]
    else:
        assert ours["input_spec"] == theirs["input_spec"]


def _inputs(name, b):
    rng = np.random.RandomState(b)
    if name == "mlp":
        return [rng.randn(b, 8).astype(np.float32)]
    ids = rng.randint(0, BERT["vocab_size"], (b, S)).astype(np.int64)
    mask = np.ones((b, S), np.int64)
    mask[0, S // 2 + 5:] = 0                       # a padded row
    return [ids, mask]


@pytest.mark.parametrize("name", ["mlp", "bert"])
def test_predictor_runs_the_exported_program_as_the_reference(saved, name):
    _, tm, jp, tp = saved[name]
    loaded = paddle.jit.load(jp)
    for b in (3, 1):
        x = _inputs(name, b)
        # the reference's BERT artifact took only batch 1 (its fallback)
        ref = (np.asarray(loaded(*[paddle.to_tensor(a) for a in x]).numpy())
               if name == "mlp" or b == 1 else None)
        cfg = Config(tp + ".pdmodel")
        cfg.disable_gpu()
        cfg.enable_profile()
        pred = create_predictor(cfg)
        assert pred.get_input_names() == [f"x{i}" for i in range(len(x))]
        for i, a in enumerate(x):
            pred.get_input_handle(f"x{i}").copy_from_cpu(a)
        calls = []
        orig = tfa._plain_fwd
        tfa._plain_fwd = lambda *a: calls.append(1) or orig(*a)
        try:
            assert pred.run()
        finally:
            tfa._plain_fwd = orig
        out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
        if ref is not None:
            np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
        eager = tm(*[torch.as_tensor(a) for a in x]).detach().numpy()
        np.testing.assert_allclose(out, eager, atol=1e-6, rtol=0)
        # one K1 call per layer through the exported program's operator
        assert len(calls) == (2 if name == "bert" else 0)
    if name == "bert":
        layer = jit.load(tp, device="cpu")
        nodes = [n for n in layer._exported.graph.nodes
                 if "flash_fwd" in str(n.target)]
        assert len(nodes) == BERT["num_hidden_layers"]
        assert set(pred.profile_report()) == set(
            jinference.Predictor(jinference.Config(jp)).profile_report())


def test_op_version_compatibility_cases(saved, tmp_path):
    assert op_version.get_op_version("flash_attention") >= 2
    with pytest.raises(ValueError):
        op_version.register_op_version("flash_attention", 1)
    _, tm, _, _ = saved["mlp"]
    path = str(tmp_path / "m")
    jit.save(tm, path, input_spec=[jit.InputSpec([4, 8], "float32")])
    meta = _meta(path)
    assert meta["op_versions"]["exported_program"] == 1
    assert meta["input_spec"] == [((4, 8), "float32")]

    def rewrite(ops):
        meta["op_versions"] = ops
        with open(path + ".pdmeta", "wb") as f:
            pickle.dump(meta, f)

    rewrite({"flash_attention": 99, "exported_program": 1})
    with pytest.raises(op_version.OpVersionError):
        jit.load(path, device="cpu")
    rewrite({"op_from_the_future": 1})
    with pytest.warns(UserWarning):
        jit.load(path, device="cpu")
    with pytest.raises(op_version.OpVersionError):
        jit.load(path, device="cpu", strict_op_versions=True)
    rewrite({"exported_program": 1})
    out = jit.load(path, device="cpu")(np.zeros((4, 8), np.float32))
    assert tuple(out.shape) == (4, 4)


def test_refusals(saved, tmp_path):
    _, _, jp, _ = saved["mlp"]
    with pytest.raises(jit.ArtifactFormatError, match="torch.export"):
        jit.load(jp, device="cpu")
    with pytest.raises(ValueError):
        create_predictor(Config().disable_gpu())
    cfg = Config(jp)
    cfg.enable_xpu()
    with pytest.raises(UnimplementedError):
        create_predictor(cfg)
    for opt in ("program_set", "program_cache_dir"):
        # ported: taken and passed on to the predictor
        cfg = Config(jp).enable_serving(model=object(), **{opt: "x"})
        assert cfg._serving[opt] == "x"
    # recsys serving is ported: recorded, and refused without a table
    cfg = Config(jp).enable_recsys_serving(model=1, table=2)
    assert cfg.recsys_enabled() and not Config(jp).recsys_enabled()
    with pytest.raises(ValueError, match="table="):
        Config(jp).enable_recsys_serving(model=1)
    assert Config(jp).torch_device() == "cuda:0"
    cfg = Config(jp)
    cfg.enable_use_gpu(device_id=1)
    assert cfg.torch_device() == "cuda:1"
    if not torch.cuda.is_available():
        with pytest.raises(UnavailableError):
            create_predictor(Config(jp))   # the card by default
    bare = str(tmp_path / "bare")
    jit.save(tnn.Linear(2, 2, device="cpu"), bare)
    with pytest.raises(FileNotFoundError):
        jit.load(bare, device="cpu")


@pytest.fixture(scope="module")
def gpt_artifact(tmp_path_factory):
    """A reference jit.save of the tiny GPT (weights and metadata)."""
    paddle.seed(1)
    jm = jmodels.GPTForPretraining(jmodels.GPTConfig(**TINY))
    jm.eval()
    prefix = str(tmp_path_factory.mktemp("gpt") / "gpt")
    paddle.jit.save(jm, prefix)
    assert os.path.exists(prefix + ".pdiparams.npz")
    return prefix


def _serve(pred, submit_kw, gateway):
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 128, (n,)).tolist() for n in (3, 6, 9, 12)]
    resps = [pred.submit(p, 8 + i, **submit_kw[i % len(submit_kw)])
             for i, p in enumerate(prompts)]
    resps.append(pred.submit(prompts[0], 6, decode_strategy="sampling",
                             temperature=0.8, top_k=5, seed=9))
    (pred.gateway if gateway else pred.engine).run_until_drained(timeout=240)
    return [r.tokens(timeout=5) for r in resps]


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["f32", "int8"])
def test_serving_predictor_serves_a_reference_artifact(gpt_artifact,
                                                       quantize):
    gateway = quantize is not None
    opts = dict(SERVE, quantize=quantize, start=False)
    kw = [{}]
    if gateway:
        kw = [{"tenant": "gold", "priority": PRIORITY_HIGH},
              {"tenant": "free"}]
    from paddle_tpu.serving import TenantConfig as JTenant
    jcfg = jinference.Config(gpt_artifact)
    jcfg.enable_serving(
        model_provider=lambda: jmodels.GPTForPretraining(
            jmodels.GPTConfig(**TINY)),
        gateway={"tenants": {"gold": JTenant(weight=4.0),
                             "free": JTenant(max_priority=0)}}
        if gateway else None, **opts)
    jpred = jinference.create_predictor(jcfg)
    cfg = Config(gpt_artifact + ".pdiparams.npz")
    cfg.disable_gpu()
    pred = create_predictor(cfg.enable_serving(
        model_provider=lambda: tmodels.GPTForPretraining(
            tmodels.GPTConfig(**TINY), device="cpu"),
        gateway={"tenants": {"gold": TenantConfig(weight=4.0),
                             "free": TenantConfig(max_priority=0)}}
        if gateway else None, **opts))
    try:
        assert pred.engine.warm and pred.engine.kv == "paged"
        assert _serve(pred, kw, gateway) == _serve(jpred, kw, gateway)
        ours, theirs = pred.profile_report(), jpred.profile_report()
        assert set(ours) == set(theirs)
        for key in ("config", "observability", "serving"):
            assert set(ours[key]) == set(theirs[key]), key
        if gateway:
            assert set(ours["gateway"]) == set(theirs["gateway"])
            assert ours["gateway"]["admitted"] == 5
        assert ours["serving"]["post_warmup_compiles"] == 0
    finally:
        pred.close()
        jpred.close()


class _BatchBranch(tnn.Layer):
    """A forward that branches on its batch size: not shape-polymorphic."""

    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(8, 4, device="cpu")

    def forward(self, x):
        if x.shape[0] == 2:
            return self.fc(x).sum(0, keepdim=True)
        return self.fc(x)


def test_a_failed_symbolic_export_falls_back_to_concrete_shapes(tmp_path):
    """As the reference: a warning, ``meta["export_fallback"]`` and the
    concrete program (every -1 = 1)."""
    path = str(tmp_path / "branch")
    layer = _BatchBranch().eval()
    with pytest.warns(UserWarning, match="CONCRETE"):
        jit.save(layer, path, input_spec=[jit.InputSpec([-1, 8])])
    meta = _meta(path)
    assert meta["export_fallback"].startswith("concrete: ")
    assert meta["input_spec"] == [((1, 8), "float32")]
    x = np.random.RandomState(0).randn(1, 8).astype(np.float32)
    got = jit.load(path, device="cpu")(x)
    np.testing.assert_allclose(got.numpy(), layer(torch.as_tensor(x))
                               .detach().numpy(), atol=1e-6)
