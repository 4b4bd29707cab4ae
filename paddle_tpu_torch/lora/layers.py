"""LoRA adapter layers (port of paddle_tpu/lora/layers.py): the train-side
wrapper and the serve-side batched hook.

- ``LoRALinear`` (train) holds real rank-r parameters (``lora_A``,
  ``lora_B``) next to its frozen ``base`` layer, so they flow through
  ``state_dict()``, ``jit.TrainStep`` (which takes as trainable what
  requires a gradient) and recompute like any other parameter.
  ``apply_lora`` freezes the whole model first, so only the factors move.
- The serve side changes no module: ``attach_serving_lora`` registers a
  forward hook on each target that adds ``scale[aid] * (x @ A[aid]) @
  B[aid]`` to the layer's output, each row of the batch with its own
  adapter id.  The factor stacks ``[max_adapters+1, ...]`` and the ids
  come from a thread-local ``adapter_context`` that the serving engine's
  programs enter around the model's forward: the stacks are allocated
  once and the ids are a program input buffer, so a captured graph reads
  both by address and heterogeneous adapters decode in one step.  Row 0
  of every stack is zero with scale 0: id 0 is the base model, bit for
  bit (``y + 0.0``).  The hook adds no parameter, buffer or submodule, so
  the ``state_dict()`` keys (``swap_weights``, ``load_paddle_state``) are
  unchanged.
- The delta is computed in the factors' f32 and added to the layer's
  output with torch's promotion: a bf16 layer's hooked output is f32, as
  the reference's (jnp promotes bf16 + f32 the same way).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..nn.layer_base import Layer
from ..tensor.linalg import matmul

__all__ = ["LoRALinear", "LoRAWrapper", "apply_lora", "DEFAULT_TARGETS",
           "adapter_context", "attach_serving_lora", "lora_keys"]

# GPTBlock's four projections, matched by attribute name anywhere in the
# module tree
DEFAULT_TARGETS = ("qkv", "proj", "ffn_in", "ffn_out")


def _linear_like(module) -> bool:
    """A module with in/out feature counts: ``Linear`` and
    ``quantization.Int8WeightOnlyLinear`` alike (the factors stay f32 on
    an int8 base)."""
    return (isinstance(module, nn.Module) and hasattr(module, "in_features")
            and hasattr(module, "out_features"))


class LoRALinear(Layer):
    """Frozen base + trainable rank-r update: ``y = base(x) +
    (alpha/rank) * (x @ A) @ B``.  ``A`` is drawn from Normal(0, 1/rank)
    (``generator`` when given), ``B`` starts at zero: at step 0 the
    wrapped layer is the base layer exactly."""

    def __init__(self, base, rank: int = 8, alpha: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not _linear_like(base):
            raise TypeError(
                f"LoRALinear needs a linear-like base layer with "
                f"in_features/out_features, got {type(base).__name__}")
        if rank <= 0:
            raise ValueError(f"LoRA rank must be positive, got {rank}")
        self.rank = int(rank)
        self.alpha = float(alpha if alpha is not None else 2 * rank)
        self.scaling = self.alpha / self.rank
        self.base = base
        base.requires_grad_(False)
        in_f, out_f = int(base.in_features), int(base.out_features)
        self.in_features, self.out_features = in_f, out_f
        dev = next((t.device for t in list(base.parameters())
                    + list(base.buffers())), torch.device("cpu"))
        self.lora_A = nn.Parameter(torch.empty(in_f, self.rank, device=dev))
        self.lora_B = nn.Parameter(torch.zeros(self.rank, out_f, device=dev))
        with torch.no_grad():
            self.lora_A.normal_(0.0, 1.0 / self.rank, generator=generator)

    def forward(self, x):
        y = self.base(x)
        return y + matmul(matmul(x, self.lora_A), self.lora_B) * self.scaling

    def merged_weight(self):
        """The dense equivalent ``W + scaling * A @ B`` (an offline merge;
        a float base only)."""
        return (self.base.weight.detach()
                + self.scaling * (self.lora_A.detach() @ self.lora_B.detach()))

    def extra_repr(self):
        return (f"rank={self.rank}, alpha={self.alpha}, "
                f"base={type(self.base).__name__}")


def _walk_targets(model: nn.Module, targets: Sequence[str], prefix=""):
    """(parent, attribute name, dotted path, child) of every linear-like
    child whose attribute name is in ``targets``, in module-tree order."""
    for name, child in list(model.named_children()):
        path = f"{prefix}.{name}" if prefix else name
        if name in targets and _linear_like(child):
            yield model, name, path, child
        else:
            yield from _walk_targets(child, targets, path)


def apply_lora(model: nn.Module, rank: int = 8, alpha: Optional[float] = None,
               targets: Sequence[str] = DEFAULT_TARGETS,
               generator: Optional[torch.Generator] = None):
    """In-place LoRA conversion for training: freezes every parameter of
    ``model``, then swaps each target for a ``LoRALinear`` whose factors
    are the only trainables left.  Returns the wrapped dotted paths."""
    model.requires_grad_(False)
    wrapped = []
    for parent, name, path, child in _walk_targets(model, tuple(targets)):
        if isinstance(child, LoRALinear):
            continue
        setattr(parent, name, LoRALinear(child, rank=rank, alpha=alpha,
                                         generator=generator))
        wrapped.append(path)
    if not wrapped:
        raise ValueError(
            f"apply_lora found no linear-like layers named {tuple(targets)} "
            f"in {type(model).__name__}")
    return wrapped


class LoRAWrapper(Layer):
    """Model-level handle: wraps ``model`` in place (``apply_lora``) and
    keeps the train -> export lifecycle in one object; its state names
    carry the ``model.`` hop, as the reference's."""

    def __init__(self, model: nn.Module, rank: int = 8,
                 alpha: Optional[float] = None,
                 targets: Sequence[str] = DEFAULT_TARGETS):
        super().__init__()
        self.paths = apply_lora(model, rank=rank, alpha=alpha,
                                targets=targets)
        self.model = model
        self.rank = int(rank)
        self.targets = tuple(targets)

    def forward(self, *args, **kwargs):
        return self.model(*args, **kwargs)

    def trainable_parameters(self):
        """The rank-r factors: everything else is frozen."""
        return [p for p in self.model.parameters() if p.requires_grad]

    def export(self, path: str, alpha=None) -> str:
        """The adapter-only artifact; returns its file sha256."""
        from .train import export_adapter
        return export_adapter(self.model, path, alpha=alpha)

    def load(self, path: str):
        """Restore exported factors into this wrapper."""
        from .train import load_adapter
        return load_adapter(self.model, path)

    def extra_repr(self):
        return f"rank={self.rank}, wrapped={len(self.paths)}"


# ---------------------------------------------------------------------------
# serving: the batched hook and its context
# ---------------------------------------------------------------------------

_TLS = threading.local()


class adapter_context:
    """The factor stacks ({key: (A, B)}), the (max_adapters+1,) scales and
    the (B,) int adapter ids of the batch's rows, for every hooked layer
    the forward reaches in this thread.  The serving programs enter it
    around the model's forward (decode: one id per slot, around the whole
    chunk; prefill: one id).  The ids do not change inside a context, so
    each target's rows are gathered once per context (``factors``) and
    every token of a decode chunk reuses them."""

    __slots__ = ("stacks", "scales", "aid", "_rows", "_prev")

    def __init__(self, stacks: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                 scales: torch.Tensor, aid: torch.Tensor):
        self.stacks = stacks
        self.scales = scales
        self.aid = aid
        self._rows = {}
        self._prev = None

    def factors(self, key: str):
        """(A[aid], B[aid], scale[aid]) of target ``key``: (B, in, r),
        (B, r, out), (B,); ids out of range clip, as the reference's
        ``take(mode="clip")``."""
        got = self._rows.get(key)
        if got is None:
            idx = self._rows.get(None)
            if idx is None:
                idx = self.aid.to(torch.long).clamp(0,
                                                    self.scales.shape[0] - 1)
                self._rows[None] = idx
            stack_a, stack_b = self.stacks[key]
            got = (stack_a.index_select(0, idx), stack_b.index_select(0, idx),
                   self.scales.index_select(0, idx))
            self._rows[key] = got
        return got

    def __enter__(self):
        self._prev = getattr(_TLS, "ctx", None)
        _TLS.ctx = self
        return self

    def __exit__(self, *exc):
        _TLS.ctx = self._prev
        return False


def _current_ctx():
    return getattr(_TLS, "ctx", None)


def _lora_hook(lora_key: str):
    """The serving delta as a forward hook: outside an ``adapter_context``
    the layer is the base verbatim; inside one, each row of x (B, ..., in)
    takes its adapter's factors (gathered by id, once per context) and
    adds ``((x @ A) @ B) * scale`` by two batched matmuls."""

    def hook(layer, inputs, output):
        ctx = _current_ctx()
        if ctx is None:
            return None
        a, b, s = ctx.factors(lora_key)
        x = inputs[0]
        xr = x.reshape(x.shape[0], -1, x.shape[-1])
        xr = xr.to(torch.promote_types(xr.dtype, a.dtype))
        delta = torch.bmm(torch.bmm(xr, a), b) * s[:, None, None]
        return output + delta.reshape(tuple(x.shape[:-1]) + (b.shape[-1],))
    return hook


def attach_serving_lora(model: nn.Module,
                        targets: Sequence[str] = DEFAULT_TARGETS):
    """Arm ``model`` for batched multi-adapter serving: a forward hook on
    every target linear, and nothing else (no parameter, buffer or
    submodule).  Returns {dotted path: (in_features, out_features)}, which
    the registry sizes its stacks from.  Refuses a train-side
    ``LoRALinear`` and a second attach."""
    shapes = {}
    for _parent, _name, path, child in _walk_targets(model, tuple(targets)):
        if isinstance(child, LoRALinear):
            raise ValueError(
                f"layer {path} is a train-side LoRALinear; serve either "
                "the merged model or the base model + exported adapter, "
                "not the training wrapper")
        if getattr(child, "_lora_serving_key", None) is not None:
            raise ValueError(f"layer {path} already has serving LoRA "
                             "attached")
        child._lora_serving_key = path
        child.register_forward_hook(_lora_hook(path))
        shapes[path] = (int(child.in_features), int(child.out_features))
    if not shapes:
        raise ValueError(
            f"no linear-like layers named {tuple(targets)} found in "
            f"{type(model).__name__}")
    return shapes


def lora_keys(model: nn.Module):
    """Sorted dotted paths of LoRA-wrapped layers (train or serve)."""
    keys = []

    def walk(module, prefix=""):
        for name, child in module.named_children():
            path = f"{prefix}.{name}" if prefix else name
            if (isinstance(child, LoRALinear)
                    or getattr(child, "_lora_serving_key", None)):
                keys.append(path)
            else:
                walk(child, path)
    walk(model)
    return sorted(keys)
