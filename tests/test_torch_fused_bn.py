"""paddle_tpu_torch's fused training BatchNorm (ops/fused_bn_act.py) against
the JAX package on the CPU.

The port's ``bn_act_train``, ``bn2_act_train`` and ``bn_act_pool_train``
(their autograd Functions over the plain versions of K5-K9 on the CPU)
against the reference's, run with ``paddle_tpu.ops.fused_bn_act.
_INTERPRET = True`` so that its Pallas kernels run through the
interpreter (at an M the reference's block rule cannot tile, it takes its
own plain path).  Outputs, the f32 batch statistics and the gradients of
x, gamma, beta and the residual (with cotangents on the statistics too, so
that their folding into the dx coefficients is checked), across the
activations, residual / dual / pooled forms, f32 and bf16, and odd C and
M.  Inputs are drawn with numpy from a seed and handed to both.

Tolerances, the reference's own (tests/test_fused_bn.py): f32 within 1e-5
(gradients within 2e-5 of max(1, each tensor's largest |value|), as the
sums run in another order); bf16 within 2e-2 of max(1, each tensor's
largest |value|) (one bf16 unit of the largest values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import fused_bn_act as JK

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.core import buffer_updates
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import fused_bn_act as TK

# tiny shapes gain nothing from intra-op threads, and idle OpenMP threads
# spinning would take cores from the test files running beside this one
torch.set_num_threads(1)

EPS = 1e-5


@pytest.fixture
def interpret_kernels():
    JK._INTERPRET = True
    yield
    JK._INTERPRET = False


def _dtypes(bf16):
    return ((jnp.bfloat16, torch.bfloat16) if bf16
            else (jnp.float32, torch.float32))


def _inputs(shape, bf16, seed, n_res=1):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    acts = [(1.5 * rng.randn(*shape) + 0.3).astype(np.float32)
            for _ in range(1 + n_res)]
    params = [(rng.rand(c) + 0.5).astype(np.float32),
              rng.randn(c).astype(np.float32),
              (rng.rand(c) + 0.5).astype(np.float32),
              rng.randn(c).astype(np.float32)]
    return acts, params, rng


def _close(got, want, bf16, grad=False):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    tol = 2e-2 if bf16 else (2e-5 if grad else 1e-5)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


def _jax_run(fn, jins, jcts):
    out, vjp = jax.vjp(fn, *jins)
    return out, vjp(tuple(jcts))


def _port_run(fn, tins, tcts):
    tins = [t.clone().requires_grad_() for t in tins]
    out = fn(*tins)
    return out, torch.autograd.grad(out, tins, tcts)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


SHAPES = [(4, 8, 8, 32), (3, 5, 7, 24), (2, 3, 3, 40), (4, 8, 8, 24)]


@pytest.mark.parametrize("shape,act,residual,bf16", [
    (SHAPES[0], "relu", True, False), (SHAPES[0], "relu", True, True),
    (SHAPES[0], "relu6", False, True), (SHAPES[1], None, False, False),
    (SHAPES[1], "relu6", True, True), (SHAPES[2], "relu6", False, False),
    (SHAPES[2], None, True, True), (SHAPES[3], "relu", False, False),
    (SHAPES[3], "relu6", True, False), (SHAPES[3], None, False, True)])
def test_bn_act_train_matches_reference(interpret_kernels, shape, act,
                                        residual, bf16):
    (x, r), (g, b, _, _), rng = _inputs(shape, bf16, 1)
    jdt, tdt = _dtypes(bf16)
    cy = rng.randn(*shape).astype(np.float32)
    cm, cv = rng.randn(shape[-1]).astype(np.float32), \
        rng.randn(shape[-1]).astype(np.float32)
    jins = [jnp.asarray(x, jdt), jnp.asarray(g), jnp.asarray(b)]
    tins = [torch.from_numpy(x).to(tdt), torch.from_numpy(g),
            torch.from_numpy(b)]
    if residual:
        jins.append(jnp.asarray(r, jdt))
        tins.append(torch.from_numpy(r).to(tdt))

    def jfn(x, g, b, r=None):
        return JK.bn_act_train(x, g, b, EPS, act, r, channel_last=True)

    def tfn(x, g, b, r=None):
        return TK.bn_act_train(x, g, b, EPS, act, r, channel_last=True)
    jout, jgrads = _jax_run(jfn, jins, [jnp.asarray(cy, jdt),
                                        jnp.asarray(cm), jnp.asarray(cv)])
    tout, tgrads = _port_run(tfn, tins, [torch.from_numpy(cy).to(tdt),
                                         torch.from_numpy(cm),
                                         torch.from_numpy(cv)])
    assert tout[0].dtype == tdt and tout[1].dtype == torch.float32
    for jo, to in zip(jout, tout):
        _close(_np(to), _np(jo), bf16)
    for jg, tg in zip(jgrads, tgrads):
        _close(_np(tg), _np(jg), bf16, grad=True)


@pytest.mark.parametrize("shape,act,bf16", [
    (SHAPES[0], "relu", False), (SHAPES[0], "relu", True),
    (SHAPES[1], None, False), (SHAPES[2], "relu6", True),
    (SHAPES[3], "relu6", False)])
def test_bn2_act_train_matches_reference(interpret_kernels, shape, act,
                                         bf16):
    (x, r), (gx, bx, gr, br), rng = _inputs(shape, bf16, 2)
    jdt, tdt = _dtypes(bf16)
    c = shape[-1]
    cts = [rng.randn(*shape).astype(np.float32)] + \
        [rng.randn(c).astype(np.float32) for _ in range(4)]
    jins = [jnp.asarray(x, jdt), jnp.asarray(gx), jnp.asarray(bx),
            jnp.asarray(r, jdt), jnp.asarray(gr), jnp.asarray(br)]
    tins = [torch.from_numpy(x).to(tdt), torch.from_numpy(gx),
            torch.from_numpy(bx), torch.from_numpy(r).to(tdt),
            torch.from_numpy(gr), torch.from_numpy(br)]
    jout, jgrads = _jax_run(
        lambda *a: JK.bn2_act_train(*a, EPS, act, channel_last=True), jins,
        [jnp.asarray(cts[0], jdt)] + [jnp.asarray(t) for t in cts[1:]])
    tout, tgrads = _port_run(
        lambda *a: TK.bn2_act_train(*a, EPS, act, channel_last=True), tins,
        [torch.from_numpy(cts[0]).to(tdt)] +
        [torch.from_numpy(t) for t in cts[1:]])
    assert len(tout) == 5
    for jo, to in zip(jout, tout):
        _close(_np(to), _np(jo), bf16)
    for jg, tg in zip(jgrads, tgrads):
        _close(_np(tg), _np(jg), bf16, grad=True)


POOL_SHAPES = [(2, 12, 12, 24), (3, 9, 11, 40)]
MAX312, AVG312, MAX220 = ("max", 3, 2, 1), ("avg", 3, 2, 1), ("max", 2, 2, 0)


@pytest.mark.parametrize("shape,pool,act,bf16", [
    (POOL_SHAPES[0], MAX312, "relu", False),
    (POOL_SHAPES[0], MAX312, "relu", True),
    (POOL_SHAPES[0], AVG312, "relu", False),
    (POOL_SHAPES[1], AVG312, None, True),
    (POOL_SHAPES[1], MAX220, None, False),
    (POOL_SHAPES[0], MAX220, "relu", True)])
def test_bn_act_pool_train_matches_reference(interpret_kernels, shape, pool,
                                             act, bf16):
    (x,), (g, b, _, _), rng = _inputs(shape, bf16, 3, n_res=0)
    jdt, tdt = _dtypes(bf16)
    jins = [jnp.asarray(x, jdt), jnp.asarray(g), jnp.asarray(b)]
    tins = [torch.from_numpy(x).to(tdt), torch.from_numpy(g),
            torch.from_numpy(b)]
    n, h, w, c = shape
    kind, k, st, p = TK._pool_norm(pool)
    ho, wo = TK._pool_out(h, w, k, st, p)
    cts = [rng.randn(n, ho, wo, c).astype(np.float32),
           rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)]
    jout, jgrads = _jax_run(
        lambda *a: JK.bn_act_pool_train(*a, EPS, act, pool,
                                        channel_last=True), jins,
        [jnp.asarray(cts[0], jdt), jnp.asarray(cts[1]), jnp.asarray(cts[2])])
    tout, tgrads = _port_run(
        lambda *a: TK.bn_act_pool_train(*a, EPS, act, pool,
                                        channel_last=True), tins,
        [torch.from_numpy(cts[0]).to(tdt), torch.from_numpy(cts[1]),
         torch.from_numpy(cts[2])])
    for jo, to in zip(jout, tout):
        _close(_np(to), _np(jo), bf16)
    for jg, tg in zip(jgrads, tgrads):
        _close(_np(tg), _np(jg), bf16, grad=True)


@pytest.mark.parametrize("form", ["single", "residual", "dual", "pool"])
def test_channels_last_nchw_input_is_read_without_a_copy(form):
    """A logical NCHW tensor in channels-last memory (channel_last=False)
    gives the same result as its (N, H, W, C) view, forward and backward,
    with no layout copy."""
    (x, r), (g, b, gr, br), rng = _inputs((2, 6, 5, 24), False, 4)
    nhwc = [torch.from_numpy(x), torch.from_numpy(r)]
    nchw = [t.permute(0, 3, 1, 2) for t in nhwc]
    pg, pb, pgr, pbr = (torch.from_numpy(t) for t in (g, b, gr, br))

    def run(xx, rr, channel_last):
        if form == "single":
            return TK.bn_act_train(xx, pg, pb, EPS, "relu", None,
                                   channel_last)[0]
        if form == "residual":
            return TK.bn_act_train(xx, pg, pb, EPS, "relu", rr,
                                   channel_last)[0]
        if form == "dual":
            return TK.bn2_act_train(xx, pg, pb, rr, pgr, pbr, EPS, "relu",
                                    channel_last)[0]
        return TK.bn_act_pool_train(xx, pg, pb, EPS, "relu",
                                    ("max", 3, 2, 1), channel_last)[0]

    before = (TK.bn_act_train.relayouts, TK.bn2_act_train.relayouts,
              TK.bn_act_pool_train.relayouts)
    ins = [t.clone().requires_grad_() for t in nchw]
    y = run(*ins, False)
    assert y.is_contiguous(memory_format=torch.channels_last)
    y.backward(torch.ones_like(y).contiguous(
        memory_format=torch.channels_last))
    assert (TK.bn_act_train.relayouts, TK.bn2_act_train.relayouts,
            TK.bn_act_pool_train.relayouts) == before
    ref_ins = [t.clone().requires_grad_() for t in nhwc]
    y_ref = run(*ref_ins, True)
    y_ref.backward(torch.ones_like(y_ref))
    torch.testing.assert_close(y, y_ref.permute(0, 3, 1, 2))
    torch.testing.assert_close(ins[0].grad, ref_ins[0].grad.permute(
        0, 3, 1, 2))
    # a plain NCHW-contiguous input takes one counted copy each way
    y = run(nchw[0].contiguous().requires_grad_(), nchw[1].contiguous(),
            False)
    y.sum().backward()
    assert sum((TK.bn_act_train.relayouts, TK.bn2_act_train.relayouts,
                TK.bn_act_pool_train.relayouts)) > sum(before)


def test_every_wrapper_counts_its_calls_and_no_launches_on_the_cpu():
    (x, r), (g, b, _, _), _ = _inputs((2, 4, 4, 8), False, 5)
    names = ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx",
             "bn_pool_apply")
    calls = {n: getattr(TK, n).calls for n in names}
    launches = {n: getattr(TK, n).launches for n in names}
    xt = torch.from_numpy(x).requires_grad_()
    y = TK.bn_act_train(xt, torch.from_numpy(g), torch.from_numpy(b), EPS,
                        "relu", torch.from_numpy(r))[0]
    y.sum().backward()
    TK.bn_act_pool_train(xt, torch.from_numpy(g), torch.from_numpy(b))
    got = {n: getattr(TK, n).calls - calls[n] for n in names}
    assert got == {"bn_stats": 2, "bn_apply": 1, "bn_bwd_reduce": 1,
                   "bn_bwd_dx": 1, "bn_pool_apply": 1}
    assert {n: getattr(TK, n).launches for n in names} == launches


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_fused_bn_act_amp_contract_and_running_stats(level):
    """F.fused_bn_act under AMP: O2 casts x, gamma, beta and the residual
    to bf16 (the output is bf16), O1 leaves them f32; in both the
    running statistics take momentum * old + (1 - momentum) * batch, and
    they match the reference's."""
    rng = np.random.RandomState(6)
    x = rng.randn(4, 16, 6, 6).astype(np.float32)
    res = rng.randn(4, 16, 6, 6).astype(np.float32)
    w = (rng.rand(16) + 0.5).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    rm, rv = np.zeros(16, np.float32), np.ones(16, np.float32)
    from paddle_tpu import amp as jamp
    from paddle_tpu.core.tensor import Tensor
    jrm, jrv = Tensor(jnp.asarray(rm)), Tensor(jnp.asarray(rv))
    with jamp.auto_cast(level=level):
        jy = JF.fused_bn_act(Tensor(jnp.asarray(x)), jrm, jrv,
                             Tensor(jnp.asarray(w)), Tensor(jnp.asarray(b)),
                             training=True, activation="relu",
                             residual=Tensor(jnp.asarray(res)))
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    with tamp.auto_cast(level=level):
        ty = TF.fused_bn_act(torch.from_numpy(x), trm, trv,
                             torch.from_numpy(w), torch.from_numpy(b),
                             training=True, activation="relu",
                             residual=torch.from_numpy(res))
    want = torch.bfloat16 if level == "O2" else torch.float32
    assert ty.dtype == want and str(jy._data.dtype) == str(want)[6:]
    bf16 = level == "O2"
    _close(_np(ty), _np(jy._data), bf16)
    _close(trm.numpy(), np.asarray(jrm._data), bf16)
    _close(trv.numpy(), np.asarray(jrv._data), bf16)
    mean = x.mean(axis=(0, 2, 3))
    if not bf16:
        np.testing.assert_allclose(trm.numpy(), 0.1 * mean, atol=1e-6)


def test_buffer_updates_are_logged_under_capture_and_compound():
    buf = torch.zeros(3)
    with buffer_updates.capture() as log:
        assert buffer_updates.capturing()
        buffer_updates.apply(buf, buffer_updates.current(buf) + 1.0)
        buffer_updates.apply(buf, buffer_updates.current(buf) + 1.0)
        assert torch.equal(buf, torch.zeros(3))
    assert not buffer_updates.capturing()
    assert torch.equal(buffer_updates.resolve(log, {"b": buf})["b"],
                       torch.full((3,), 2.0))
    buffer_updates.apply(buf, torch.ones(3))
    assert torch.equal(buf, torch.ones(3))


def test_fused_bn_act_rejects_what_the_reference_rejects():
    x = torch.zeros(2, 4, 3, 3)
    rm, rv = torch.zeros(4), torch.ones(4)
    with pytest.raises(ValueError):
        TF.fused_bn_act(x, rm, rv, activation="gelu")
    with pytest.raises(ValueError):
        TF.fused_bn_act(x, rm, rv, activation="relu", residual=x,
                        pool=("max", 3, 2, 1))
    with pytest.raises(ValueError):
        TK.bn_act_pool_train(x.permute(0, 2, 3, 1), torch.ones(4),
                             torch.zeros(4), pool=("median", 3, 2, 1))


# ---------------------------------------------------------------------------
# K9's launch plan (CPU: the plan is host arithmetic; the kernel runs on
# the card, tests/test_torch_kernels_cuda.py)
# ---------------------------------------------------------------------------

H100_SMS = 132
H100_SMEM = (233472, 232448)   # shared memory per SM, most per block


def test_pool_plan_at_the_resnet_stem():
    """bf16 stem rows (14,336 bytes): two blocks per SM, each a ring of
    RING_DEPTH rows within half the SM's shared memory, whole images per
    block: 256 images on 264 resident blocks."""
    p = TK._pool_plan(256, 112, 112, 64, 2, "max", (3, 3), (2, 2), (1, 1),
                      H100_SMS, H100_SMEM)
    assert p.route == "ring" and TK.POOL_PER_SM == 2
    assert p.ring == TK.RING_DEPTH and p.band == 56 and p.grid == 256
    assert p.slot_elems == 112 * 64
    smem = TK._ring_smem(p.ring, p.slot_elems * 2, 64)
    assert TK.POOL_PER_SM * (smem + TK._RESERVED) <= H100_SMEM[0]


@pytest.mark.parametrize("shape,elem,kind,k,s,p", [
    ((256, 112, 112, 64), 4, "max", (3, 3), (2, 2), (1, 1)),
    ((3, 9, 11, 24), 2, "max", (3, 3), (2, 2), (1, 1)),
    ((1, 7, 5, 3), 4, "max", (2, 3), (2, 1), (0, 1)),
    ((2, 12, 12, 40), 4, "avg", (3, 3), (1, 1), (1, 1)),
    ((2, 6, 240, 64), 4, "max", (3, 3), (2, 2), (1, 1)),
    ((2, 6, 480, 64), 2, "max", (2, 3), (2, 1), (0, 1)),
    ((1, 9, 3000, 8), 4, "max", (3, 3), (2, 2), (1, 1)),
    ((300, 56, 56, 64), 2, "max", (3, 3), (2, 2), (1, 1)),
    ((2, 14, 14, 64), 4, "avg", (14, 14), (1, 1), (0, 0)),
    ((2, 10, 10, 32), 2, "max", (9, 9), (1, 1), (0, 0)),
    ((1, 40, 40, 16), 4, "max", (17, 17), (3, 3), (2, 2)),
])
def test_pool_plan_holds_the_ring_or_takes_the_window_route(shape, elem,
                                                            kind, k, s, p):
    """The ring holds kh + max(kh, sh) rows and one mbarrier per row slot,
    within one block's (and, POOL_PER_SM times, the SM's) shared memory,
    or the plan takes the window route; the work items cover every output
    row of every image once, in whole images where the images fill the
    resident blocks."""
    n, h, w, c = shape
    plan = TK._pool_plan(n, h, w, c, elem, kind, k, s, p, H100_SMS,
                         H100_SMEM)
    slot = -(-w * c * elem // 128) * 128
    least = k[0] + max(k[0], s[0])
    budget = min(H100_SMEM[0] // 2 - TK._RESERVED, H100_SMEM[1])
    if TK._ring_smem(least, slot, c) > budget:
        assert plan.route == "window"
        return
    assert plan.route == "ring" and plan.ring >= least
    assert plan.ring == max(least, TK.RING_DEPTH) or TK._ring_smem(
        plan.ring + 1, slot, c) > budget
    assert plan.slot_elems * elem == slot
    smem = TK._ring_smem(plan.ring, slot, c)
    assert smem <= H100_SMEM[1]
    assert TK.POOL_PER_SM * (smem + TK._RESERVED) <= H100_SMEM[0]
    ho, _ = TK._pool_out(h, w, k, s, p)
    bands = -(-ho // plan.band)
    rows = sorted((img, b * plan.band + r) for img in range(n)
                  for b in range(bands)
                  for r in range(min(plan.band, ho - b * plan.band)))
    assert rows == [(img, r) for img in range(n) for r in range(ho)]
    blocks = TK.POOL_PER_SM * H100_SMS
    assert plan.grid == min(n * bands, blocks)
    assert plan.band == ho if n >= blocks else n * bands >= min(
        blocks, n * ho) // 2


def test_pool_plan_deep_rings_get_a_barrier_per_slot():
    """A 14x14 global average pool needs 28 row slots, more than 128
    bytes of barriers hold (16): the barrier area grows with the ring."""
    plan = TK._pool_plan(2, 14, 14, 64, 4, "avg", (14, 14), (1, 1), (0, 0),
                         H100_SMS, H100_SMEM)
    assert plan.route == "ring" and plan.ring == 28
    assert TK._ring_smem(28, 14 * 64 * 4, 64) == 256 + 28 * 14 * 64 * 4 + 512


@pytest.mark.parametrize("elem,route", [(2, "window"), (4, "ring")])
def test_pool_plan_sends_a_bf16_average_to_the_window_route(elem, route):
    """The ring's slots hold act(x*a + b) in x's dtype: a bf16 average
    would sum rounded values, so it takes the window route (f32 sums,
    one rounding, as the reference); a bf16 max stays on the ring."""
    args = (256, 56, 56, 64, elem)
    assert TK._pool_plan(*args, "avg", (3, 3), (2, 2), (1, 1), H100_SMS,
                         H100_SMEM).route == route
    assert TK._pool_plan(256, 112, 112, 64, 2, "max", (3, 3), (2, 2),
                         (1, 1), H100_SMS, H100_SMEM).route == "ring"


def test_pool_plan_follows_the_cards_shared_memory():
    """A card with less shared memory per SM gets a shallower ring, or
    the window route, never more than it holds."""
    small = (101376, 101376)   # 99 KB per SM
    plan = TK._pool_plan(256, 112, 112, 64, 2, "max", (3, 3), (2, 2),
                         (1, 1), H100_SMS, small)
    assert plan.route == "window"   # half an SM holds 3 stem rows, not 6
    plan = TK._pool_plan(256, 56, 56, 64, 2, "max", (3, 3), (2, 2),
                         (1, 1), H100_SMS, small)
    assert plan.route == "ring" and plan.ring == TK.RING_DEPTH
    assert 2 * (TK._ring_smem(plan.ring, 56 * 64 * 2, 64)
                + TK._RESERVED) <= small[0]


def test_pool_routes_count_only_card_launches():
    x = torch.randn(2, 7, 9, 8)
    coef = torch.stack([torch.rand(8) + 0.5, torch.randn(8)]
                       + [torch.zeros(8)] * 6)
    before = dict(TK.bn_pool_apply.routes)
    y = TK.bn_pool_apply(x, coef, "relu", "max", (3, 3), (2, 2), (1, 1))
    assert y.shape == (2, 4, 5, 8)
    assert TK.bn_pool_apply.routes == before
