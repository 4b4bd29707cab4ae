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
precision already); ``GradScaler`` (fp16 loss scaling) comes with a later
slice of the port.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["WHITE_LIST", "BLACK_LIST", "auto_cast", "amp_cast", "promote",
           "decorate"]

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

    def __init__(self, enable=True, level="O1", dtype="bfloat16"):
        self.enable = enable
        self.level = level
        self.dtype = _low_dtype(dtype)
        self.white = frozenset(WHITE_LIST)
        self.black = frozenset(BLACK_LIST)

    def __enter__(self):
        self._prev = _snapshot()
        _set((self.enable, self.dtype, self.level, self.white, self.black))
        return self

    def __exit__(self, *exc):
        _set(self._prev)
        return False


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16"):
    """paddle.amp.decorate: under O2 the models' parameters are cast to the
    low type in place.  Optimizer moments stay f32 whatever the parameter
    type (``Adam.init_state``), the reference's multi-precision rule."""
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
