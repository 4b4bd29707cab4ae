"""Automatic mixed precision (counterpart of paddle_tpu/amp/__init__.py).

The reference casts by op name at its op dispatch (``_amp_hook``): under
O1 a white-listed op casts its float inputs to the low type and a
black-listed one to f32; under O2 every op that is not black-listed casts
to the low type.  The port has no dispatcher, so its own entry points ask
``amp_cast(name, *tensors)``: ``linear`` (bias included, so its output
stays bf16), ``matmul``, ``scaled_dot_product_attention``, ``conv2d``,
``layer_norm``, ``batch_norm``, ``softmax`` and ``cross_entropy`` by their
lists; ``fused_bn_act`` / ``fused_dual_bn_act`` (x, gamma, beta and the
residual), the pools and ``relu`` / ``relu6`` are on neither list, so they
cast under O2 only.  ``torch.autocast`` is not used: its
lists differ, and it would let the bias add promote a Linear back to f32.
The cast is a differentiable ``.to``, so each gradient comes back in its
input's own type, as the reference's cast inside the vjp does.  Under O2
only those entry points cast (with ``decorate`` the parameters are low
precision already).

``GradScaler`` is the reference's dynamic loss scaling for float16: the
scale's state machine (increase after ``incr_every_n_steps`` finite
steps, decrease after ``decr_every_n_nan_or_inf`` bad ones, never below
1.0), a per-optimizer cycle state keyed by ``id`` with a weakref identity
check (an interleaved GAN loop never divides a gradient twice), and an
``unscale_`` that is one fused multi-tensor pass over the gradients with
one host read of the finite flag.
"""
from __future__ import annotations

import contextlib
import weakref

import torch

__all__ = ["WHITE_LIST", "BLACK_LIST", "auto_cast", "amp_cast", "promote",
           "decorate", "GradScaler"]

# ops always run in the low-precision type (reference fp16 white list)
WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "addmm", "scaled_dot_product_attention",
}
# ops that must stay f32 (reference black list)
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "softmax", "log_softmax",
    "cross_entropy", "nll_loss", "binary_cross_entropy", "bce_with_logits",
    "kl_div", "softmax_with_cross_entropy", "mean", "sum", "norm", "var",
    "std", "layer_norm", "batch_norm", "instance_norm", "group_norm",
    "logsumexp", "erf", "erfinv", "rsqrt", "pow", "square", "ctc_loss",
    "cumsum", "cosine_similarity",
}


class _AmpState:
    enabled = False
    dtype = torch.bfloat16
    level = "O1"
    white = frozenset()
    black = frozenset()


_state = _AmpState()


def _snapshot():
    """The active policy, for ``_restored``."""
    return (_state.enabled, _state.dtype, _state.level, _state.white,
            _state.black)


def _set(snap):
    (_state.enabled, _state.dtype, _state.level, _state.white,
     _state.black) = snap


@contextlib.contextmanager
def _restored(snap):
    """Run the block under the policy ``snap`` (a recompute region's
    recomputation runs under its first forward's policy)."""
    prev = _snapshot()
    _set(snap)
    try:
        yield
    finally:
        _set(prev)


def _low_dtype(dtype) -> torch.dtype:
    return torch.float16 if str(dtype) in ("float16", "fp16",
                                           "torch.float16") \
        else torch.bfloat16


def amp_cast(name: str, *tensors):
    """The policy for op ``name``: each floating tensor cast to the op's
    type (None and integer tensors pass through).  Returns a tuple."""
    if not _state.enabled:
        return tensors
    in_white = name in _state.white
    in_black = name in _state.black
    cast_low = (not in_black) if _state.level == "O2" else in_white
    if cast_low:
        tgt = _state.dtype
    elif in_black:
        tgt = torch.float32
    else:
        return tensors
    return tuple(t.to(tgt) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() and t.dtype != tgt else t
                 for t in tensors)


def promote(*tensors):
    """The floating tensors in their common type (None and integer
    tensors pass through), as jnp promotes mixed operands: a bf16 model
    meets f32 activations where a LoRA hook's f32 delta joined a bf16
    output.  Operands of one type are returned as they are."""
    floats = [t for t in tensors if isinstance(t, torch.Tensor)
              and t.is_floating_point()]
    if len({t.dtype for t in floats}) < 2:
        return tensors
    tgt = floats[0].dtype
    for t in floats[1:]:
        tgt = torch.promote_types(tgt, t.dtype)
    return tuple(t.to(tgt) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() else t for t in tensors)


class auto_cast:
    """paddle.amp.auto_cast context manager with the reference's lists."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16",
                 use_promote=True):
        white = set(custom_white_list or ())
        self.enable = enable
        self.level = level
        self.dtype = _low_dtype(dtype)
        self.white = frozenset(set(WHITE_LIST) | white)
        self.black = frozenset(
            (set(BLACK_LIST) | set(custom_black_list or ())) - white)

    def __enter__(self):
        self._prev = _snapshot()
        _set((self.enable, self.dtype, self.level, self.white, self.black))
        return self

    def __exit__(self, *exc):
        _set(self._prev)
        return False


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """paddle.amp.decorate: under O2 the models' parameters are cast to the
    low type in place.  Optimizer moments stay f32 whatever the parameter
    type (``Adam.init_state``), the reference's multi-precision rule, so
    ``master_weight`` and ``save_dtype`` are taken and change nothing, as
    in the reference."""
    low = _low_dtype(dtype)

    def _cast(m):
        if m is not None and level == "O2":
            m.to(dtype=low)
        return m
    if isinstance(models, (list, tuple)):
        models = [_cast(m) for m in models]
    else:
        models = _cast(models)
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling (the reference's ``amp.GradScaler``, after
    Paddle's ``update_loss_scaling`` state machine)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False   # the last unscale_'s verdict
        self._opt_states = {}     # id -> {"ref", "unscaled", "found_inf"}

    def _opt_state(self, optimizer):
        """This optimizer's cycle state; an entry whose optimizer was
        collected, or whose id was reused by another, starts afresh."""
        dead = [k for k, st in self._opt_states.items()
                if st["ref"]() is None]
        for k in dead:
            del self._opt_states[k]
        st = self._opt_states.get(id(optimizer))
        if st is None or st["ref"]() is not optimizer:
            st = {"ref": weakref.ref(optimizer), "unscaled": False,
                  "found_inf": False}
            self._opt_states[id(optimizer)] = st
        return st

    def scale(self, loss):
        """``loss`` times the scale.  Unscale guards are per optimizer and
        cleared by that optimizer's step, so scaling another loss between
        one optimizer's ``unscale_`` and its ``step`` divides nothing
        twice."""
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide the optimizer's gradients by the scale in place (once per
        cycle) and record whether all are finite: one fused multi-tensor
        pass and one host read."""
        if not self._enable:
            return
        st = self._opt_state(optimizer)
        if st["unscaled"]:
            return
        st["unscaled"] = True
        # a row-sparse gradient is unscaled through its values and stays
        # row-sparse; the inf check reads the values too
        grads = [p.grad._values() if p.grad.is_sparse else p.grad
                 for p in optimizer._parameter_list or []
                 if p.grad is not None]
        if not grads:
            self._found_inf = st["found_inf"] = False
            return
        dev = grads[0].device
        found = torch.zeros(1, dtype=torch.float32, device=dev)
        inv = torch.full((1,), 1.0 / self._scale, dtype=torch.float32,
                         device=dev)
        torch._amp_foreach_non_finite_check_and_unscale_(grads, found, inv)
        self._found_inf = st["found_inf"] = bool(found.item())

    def step(self, optimizer):
        """Unscale (unless done this cycle), step unless a gradient was
        not finite, and move the scale's state machine."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        st = self._opt_state(optimizer)
        if not st["found_inf"]:
            optimizer.step()
        self._update(st["found_inf"])
        st["unscaled"] = False
        st["found_inf"] = False

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        optimizer.clear_grad()

    def update(self):
        """Folded into ``step``, as in the reference."""

    def _update(self, found_inf):
        if not self._dynamic:
            return
        if found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def record_skip(self):
        """A bad step found elsewhere (``GuardedTrainStep``'s device
        verdict) counted as a non-finite step: the decay half of
        skip-and-decay with no host pass over the gradients."""
        from ..utils.monitor import stat_add
        stat_add("STAT_amp_skipped_steps")
        self._update(True)

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)

    set_state_dict = load_state_dict
