"""Beam search in paddle_tpu_torch against the JAX package on the CPU:
``generation.generate(decode_strategy="beam_search")``, ``beam_step``,
the RNN cells and ``nn.decode`` (gather_tree, BeamSearchDecoder +
dynamic_decode, the helper family, beam_search / beam_search_decode).

Weights are carried across by ``load_paddle_state``, inputs come from
numpy seeds.  Tolerances: ids and parents equal; scores within 1e-4
(log_softmax sums in the two libraries differ in the last bits); cell
outputs within 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.generation import beam_step as jbeam_step
from paddle_tpu.jit import state_arrays
from paddle_tpu.nn import decode as jdec

from paddle_tpu_torch import load_paddle_state
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.generation import beam_step, generate
from paddle_tpu_torch.nn import decode as tdec

from torch_parity import tiny_pair

SCORE_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=1)


def _prompts(b=2, s=6, seed=3):
    return np.random.RandomState(seed).randint(1, 128, (b, s))


@pytest.mark.parametrize("quantize,lp,eos", [(False, 0.0, None),
                                             (False, 1.0, 7),
                                             (True, 0.6, None)],
                         ids=["plain", "penalty_eos", "int8_penalty"])
def test_beam_generate_matches_reference(pair, quantize, lp, eos):
    jm, tm = tiny_pair(seed=1, quantize=True) if quantize else pair
    ids = _prompts()
    kw = dict(max_new_tokens=8, decode_strategy="beam_search", num_beams=3,
              length_penalty=lp, eos_token_id=eos, pad_token_id=0)
    jout, jsc = jm.generate(paddle.to_tensor(ids.astype(np.int32)), **kw)
    tout, tsc = generate(tm, torch.from_numpy(ids), device="cpu", **kw)
    assert tout.dtype == torch.int32 and tout.shape == (2, 8)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout.numpy()))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc.numpy()),
                               **SCORE_TOL)


def test_one_beam_is_greedy_and_scores_are_teacher_forced(pair):
    _, tm = pair
    ids = torch.from_numpy(_prompts(seed=5))
    beam, score = generate(tm, ids, max_new_tokens=8,
                           decode_strategy="beam_search", num_beams=1,
                           device="cpu")
    greedy, _ = generate(tm, ids, max_new_tokens=8, device="cpu")
    assert torch.equal(beam, greedy)
    out, sc = generate(tm, ids, max_new_tokens=8,
                       decode_strategy="beam_search", num_beams=4,
                       device="cpu")
    with torch.inference_mode():
        full = torch.cat([ids, out.to(torch.long)], dim=1)
        logits, _ = tm.forward_fixed(full, tm.gen_fixed_cache(
            2, full.shape[1]), 0)
        logp = torch.log_softmax(logits[:, ids.shape[1] - 1:-1].float(), -1)
        forced = torch.gather(logp, 2, out.to(torch.long)[..., None])
    torch.testing.assert_close(sc, forced.sum(dim=(1, 2)), rtol=1e-5,
                               atol=1e-4)


def test_beam_step_breaks_ties_as_the_reference():
    """-1e9 plus a log-prob is a tie in f32: the lower index wins, as
    jax.lax.top_k's; a finished beam extends with the keep token only."""
    rng = np.random.RandomState(0)
    b, k, v = 3, 4, 6
    logp = np.log(rng.dirichlet(np.ones(v), (b, k))).astype(np.float32)
    logp[1] = logp[1, :1]                      # every beam of row 1 equal
    logp[2, :, 2] = logp[2, :, 4]              # ties inside row 2
    scores = np.array([[0.0, -1e9, -1e9, -1e9], [-1.0] * 4,
                       [-0.5, -0.5, -2.0, -1e9]], np.float32)
    finished = np.zeros((b, k), bool)
    finished[2, 1] = True
    ref = jbeam_step(logp, scores, finished, 0)
    got = beam_step(torch.from_numpy(logp), torch.from_numpy(scores),
                    torch.from_numpy(finished), 0)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _cell_pair(kind, seed=0):
    paddle.seed(seed)
    jcell = getattr(jnn, kind)(5, 7)
    tcell = getattr(tnn, kind)(5, 7, device="cpu")
    assert set(tcell.state_dict()) == set(state_arrays(jcell))
    load_paddle_state(tcell, {k: np.asarray(v)
                              for k, v in state_arrays(jcell).items()})
    return jcell, tcell


@pytest.mark.parametrize("kind", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
def test_cells_match_reference(kind):
    jcell, tcell = _cell_pair(kind)
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5).astype(np.float32)
    h = rng.randn(3, 7).astype(np.float32)
    states = (h, rng.randn(3, 7).astype(np.float32)) \
        if kind == "LSTMCell" else h
    jst = tuple(paddle.to_tensor(s) for s in states) \
        if kind == "LSTMCell" else paddle.to_tensor(states)
    tst = tuple(torch.from_numpy(s) for s in states) \
        if kind == "LSTMCell" else torch.from_numpy(states)
    for js, ts in ((jst, tst), (None, None)):
        jout, jnew = jcell(paddle.to_tensor(x), js)
        tout, tnew = tcell(torch.from_numpy(x), ts)
        np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(),
                                   rtol=1e-5, atol=1e-5)
    bound = 1 / np.sqrt(7)
    assert all(float(p.detach().abs().max()) <= bound
               for p in tcell.parameters())


def test_lstm_cell_weight_attr_initializer_in_both_frameworks():
    """``weight_ih_attr=ParamAttr(initializer=Constant(0.1))`` reaches
    the weight in both frameworks."""
    jcell = jnn.LSTMCell(3, 4, weight_ih_attr=paddle.ParamAttr(
        initializer=jnn.initializer.Constant(0.1)))
    tcell = tnn.LSTMCell(3, 4, weight_ih_attr=tnn.ParamAttr(
        initializer=tnn.initializer.Constant(0.1)), device="cpu")
    np.testing.assert_allclose(jcell.weight_ih.numpy(), 0.1)
    np.testing.assert_allclose(tcell.weight_ih.detach().numpy(), 0.1)


def _attrs(fw, frozen_name):
    init = fw.nn.initializer
    return dict(
        weight_ih_attr=fw.ParamAttr(name="wih", initializer=init.Constant(
            0.05), learning_rate=0.5),
        weight_hh_attr=fw.ParamAttr(name=frozen_name, trainable=False,
                                    initializer=init.Constant(-0.03)),
        bias_ih_attr=fw.ParamAttr(initializer=init.Constant(0.2)),
        bias_hh_attr=fw.ParamAttr(initializer=init.Uniform(-0.1, 0.1)))


@pytest.mark.parametrize("kind", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
def test_cells_take_every_attr_as_the_reference(kind):
    """Each cell with every ``*_attr`` given (initializers, a name, a
    learning rate, ``trainable=False``) steps as the reference's at 1e-5
    (the drawn bias crosses by ``load_paddle_state``).  A
    ``bias_*_attr=False`` drops that bias in both frameworks; the port's
    step then adds none (the reference's SimpleRNNCell / GRUCell step
    cannot run without it)."""
    import paddle_tpu_torch as pt
    jcell = getattr(jnn, kind)(5, 7, **_attrs(paddle, "whh"))
    tcell = getattr(tnn, kind)(5, 7, **_attrs(pt, "whh"), device="cpu")
    load_paddle_state(tcell, {k: np.asarray(v)
                              for k, v in state_arrays(jcell).items()})
    assert tcell.weight_ih.param_name == "wih"
    assert tcell.weight_ih.optimize_attr["learning_rate"] == 0.5
    assert not tcell.weight_hh.requires_grad
    for n in ("weight_ih", "weight_hh", "bias_ih"):
        np.testing.assert_allclose(getattr(tcell, n).detach().numpy(),
                                   getattr(jcell, n).numpy(), rtol=1e-6)
    rng = np.random.RandomState(5)
    x = rng.randn(3, 5).astype(np.float32)
    h = rng.randn(3, 7).astype(np.float32)
    if kind == "LSTMCell":
        c = rng.randn(3, 7).astype(np.float32)
        jst = (paddle.to_tensor(h), paddle.to_tensor(c))
        tst = (torch.from_numpy(h), torch.from_numpy(c))
    else:
        jst, tst = paddle.to_tensor(h), torch.from_numpy(h)
    jout, _ = jcell(paddle.to_tensor(x), jst)
    tout, _ = tcell(torch.from_numpy(x), tst)
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(),
                               rtol=1e-5, atol=1e-5)
    kw = dict(_attrs(pt, "whh"), bias_hh_attr=False)
    nobias = getattr(tnn, kind)(5, 7, **kw, device="cpu")
    assert nobias.bias_hh is None
    assert getattr(jnn, kind)(5, 7, **dict(_attrs(paddle, "whh"),
                                           bias_hh_attr=False)).bias_hh is None
    with torch.no_grad():
        tcell.bias_hh.zero_()
    np.testing.assert_allclose(
        nobias(torch.from_numpy(x), tst)[0].detach().numpy(),
        tcell(torch.from_numpy(x), tst)[0].detach().numpy(), rtol=1e-6)


class _JSeq(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.cell = jnn.GRUCell(8, 16)
        self.emb = jnn.Embedding(20, 8)
        self.proj = jnn.Linear(16, 20)


class _TSeq(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.cell = tnn.GRUCell(8, 16, device="cpu")
        self.emb = tnn.Embedding(20, 8, device="cpu")
        self.proj = tnn.Linear(16, 20, device="cpu")


@pytest.fixture(scope="module")
def seq_pair():
    paddle.seed(2)
    j = _JSeq()
    t = _TSeq()
    load_paddle_state(t, {k: np.asarray(v)
                          for k, v in state_arrays(j).items()})
    return j, t


def test_gru_beam_search_decoder_matches_reference(seq_pair):
    j, t = seq_pair
    h0 = np.random.RandomState(4).randn(3, 16).astype(np.float32)
    jd = jdec.BeamSearchDecoder(j.cell, 1, 2, 4, embedding_fn=j.emb,
                                output_fn=j.proj)
    td = tdec.BeamSearchDecoder(t.cell, 1, 2, 4, embedding_fn=t.emb,
                                output_fn=t.proj)
    jout, jst, jlen = jdec.dynamic_decode(jd, inits=paddle.to_tensor(h0),
                                          max_step_num=5,
                                          return_length=True)
    with torch.no_grad():
        tout, tst, tlen = tdec.dynamic_decode(td, inits=torch.from_numpy(h0),
                                              max_step_num=5,
                                              return_length=True)
    assert tout.shape == (3, 5, 4)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout.numpy()))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_allclose(tst.log_probs.numpy(),
                               np.asarray(jst.log_probs), **SCORE_TOL)
    tiled = tdec.BeamSearchDecoder.tile_beam_merge_with_batch(
        torch.from_numpy(h0), 4)
    np.testing.assert_array_equal(tiled.numpy(), np.asarray(
        jdec.BeamSearchDecoder.tile_beam_merge_with_batch(
            paddle.to_tensor(h0), 4).numpy()))


@pytest.mark.parametrize("helper", ["training", "greedy", "sample"])
def test_basic_decoder_helpers_match_reference(seq_pair, helper):
    j, t = seq_pair
    rng = np.random.RandomState(6)
    h0 = rng.randn(2, 16).astype(np.float32)
    if helper == "training":
        x = rng.randn(2, 5, 8).astype(np.float32)
        lens = np.array([3, 5], np.int64)
        jh = jdec.TrainingHelper(paddle.to_tensor(x), paddle.to_tensor(lens))
        th = tdec.TrainingHelper(torch.from_numpy(x), torch.from_numpy(lens))
    else:
        start = np.array([1, 3], np.int64)
        cls = {"greedy": "GreedyEmbeddingHelper",
               "sample": "SampleEmbeddingHelper"}[helper]
        extra = {"softmax_temperature": 0.7, "seed": 9} \
            if helper == "sample" else {}
        jh = getattr(jdec, cls)(j.emb, paddle.to_tensor(start), 2, **extra)
        th = getattr(tdec, cls)(t.emb, torch.from_numpy(start), 2, **extra)
    jdcd = jdec.BasicDecoder(j.cell, jh, paddle.to_tensor(h0),
                             output_fn=j.proj)
    tdcd = tdec.BasicDecoder(t.cell, th, torch.from_numpy(h0),
                             output_fn=t.proj)
    jout, _ = jdec.dynamic_decode(jdcd, max_step_num=6)
    with torch.no_grad():
        tout, _ = tdec.dynamic_decode(tdcd, max_step_num=6)
    np.testing.assert_array_equal(tout.sample_ids.numpy(),
                                  np.asarray(jout.sample_ids.numpy()))
    np.testing.assert_allclose(tout.cell_outputs.numpy(),
                               np.asarray(jout.cell_outputs.numpy()),
                               rtol=1e-5, atol=1e-5)


def test_beam_search_step_matches_reference():
    """The reference suite's case (tests/test_fluid_tail_r4.py:203) and a
    seeded multi-batch one with a finished beam, both accumulation modes."""
    cases = [(np.array([[1], [2]], np.int64),
              np.array([[0.0], [-1.0]], np.float32),
              np.log(np.array([[.05, .05, .6, .2, .1],
                               [.1, .1, .2, .3, .3]], np.float32)), 2)]
    rng = np.random.RandomState(7)
    probs = rng.dirichlet(np.ones(9), 6).astype(np.float32)
    cases.append((np.array([[3], [0], [5], [1], [4], [0]], np.int64),
                  rng.randn(6, 1).astype(np.float32), probs, 3))
    for pre_ids, pre_sc, sc, k in cases:
        for acc in (True, False):
            ref = jdec.beam_search(paddle.to_tensor(pre_ids),
                                   paddle.to_tensor(pre_sc), None,
                                   paddle.to_tensor(sc), beam_size=k,
                                   end_id=0, is_accumulated=acc,
                                   return_parent_idx=True)
            got = tdec.beam_search(torch.from_numpy(pre_ids),
                                   torch.from_numpy(pre_sc), None,
                                   torch.from_numpy(sc), beam_size=k,
                                   end_id=0, is_accumulated=acc,
                                   return_parent_idx=True)
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(ref[0].numpy()))
            np.testing.assert_allclose(got[1].numpy(),
                                       np.asarray(ref[1].numpy()),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(got[2].numpy(),
                                          np.asarray(ref[2].numpy()))
    got = tdec.beam_search(torch.from_numpy(cases[0][0]),
                           torch.from_numpy(cases[0][1]), None,
                           torch.from_numpy(cases[0][2]), beam_size=2,
                           end_id=0, return_parent_idx=True)
    assert int(got[0][0, 0]) == 2 and int(got[2][0]) == 0


def test_beam_search_decode_and_gather_tree_match_reference():
    """The reference suite's multi-batch backtrack
    (tests/test_fluid_tail_r4.py:218) and a seeded T 5 x B 3 x K 4 one,
    stacked and as per-step lists."""
    ids = np.array([[10, 11, 20, 21], [12, 13, 22, 23]], np.int64)
    parents = np.array([[0, 1, 2, 3], [0, 1, 3, 3]], np.int64)
    scores = np.array([[0.1, 0.2, 0.3, 0.4], [0.5, 0.6, 0.7, 0.8]],
                      np.float32)
    rng = np.random.RandomState(8)
    t, b, k = 5, 3, 4
    ids2 = rng.randint(0, 50, (t, b * k)).astype(np.int64)
    par2 = (rng.randint(0, k, (t, b * k))
            + np.repeat(np.arange(b) * k, k)[None]).astype(np.int64)
    sc2 = rng.randn(t, b * k).astype(np.float32)
    for i, p, s, beams in ((ids, parents, scores, 2), (ids2, par2, sc2, k)):
        rf, rs = jdec.beam_search_decode(
            paddle.to_tensor(i), paddle.to_tensor(s), beam_size=beams,
            end_id=0, parents=paddle.to_tensor(p))
        gf, gs = tdec.beam_search_decode(
            torch.from_numpy(i), torch.from_numpy(s), beam_size=beams,
            end_id=0, parents=torch.from_numpy(p))
        np.testing.assert_array_equal(gf.numpy(), np.asarray(rf.numpy()))
        np.testing.assert_allclose(gs.numpy(), np.asarray(rs.numpy()))
        steps = [(torch.from_numpy(i[n]).reshape(-1, 1),
                  torch.from_numpy(p[n])) for n in range(i.shape[0])]
        lf, ls = tdec.beam_search_decode(
            steps, [torch.from_numpy(s[n]) for n in range(s.shape[0])],
            beam_size=beams, end_id=0)
        assert torch.equal(lf, gf) and torch.equal(ls, gs)
    tree = rng.randint(0, k, (t, b, k)).astype(np.int64)
    np.testing.assert_array_equal(
        tdec.gather_tree(torch.from_numpy(ids2.reshape(t, b, k)),
                         torch.from_numpy(tree)).numpy(),
        np.asarray(jdec.gather_tree(ids2.reshape(t, b, k), tree).numpy()))
    fv, sv = tdec.beam_search_decode(torch.from_numpy(ids),
                                     torch.from_numpy(scores), beam_size=2,
                                     end_id=0, parents=torch.from_numpy(
                                         parents))
    assert fv[0, 1, 0] == 21 and fv[1, 1, 0] == 22
    with pytest.raises(Exception, match="parents"):
        tdec.beam_search_decode(torch.from_numpy(ids),
                                torch.from_numpy(scores), 2, 0)
