"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py).

Each clip maps a list of (param, grad) pairs to a new one; the eager
``Optimizer.step`` applies its ``grad_clip``.  ``jit.TrainStep`` applies
none, like the reference's compiled step.  A row-sparse gradient is
densified first (norms need the merged rows; the reference likewise
densifies sparse gradients before a clip).

``clip_grad_norm_`` clips the parameters' ``.grad`` in place and returns
the total norm; ``set_gradient_clip`` sets the clip an optimizer built
without its own ``grad_clip`` applies in its eager step (the optimizer's
own has priority); ``ErrorClipByValue.apply(t)`` clips ``t``'s gradient
in the backward through a tensor hook.
"""
from __future__ import annotations

import torch

from ..core.selected_rows import dense_grad

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "set_gradient_clip",
           "ErrorClipByValue"]


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip([(p, dense_grad(g)) for p, g in params_grads])


def _skip(p, g) -> bool:
    return g is None or not getattr(p, "need_clip", True)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        return [(p, g if _skip(p, g) else g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if _skip(p, g):
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(g * g))
            scale = torch.clamp(self.clip_norm / norm.clamp_min(1e-12),
                                max=1.0)
            out.append((p, g * scale))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients scaled by clip_norm / max(global_norm, clip_norm),
    the global norm taken in f32 (no host sync)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _clip(self, params_grads):
        sq = [torch.sum(g.float() * g.float()) for p, g in params_grads
              if not _skip(p, g)]
        if not sq:
            return params_grads
        global_norm = torch.sqrt(torch.stack(sq).sum())
        scale = self.clip_norm / global_norm.clamp_min(self.clip_norm)
        return [(p, g if _skip(p, g) else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` in place by min(max_norm /
    max(total, 1e-6), 1), total the ``norm_type``-norm over all of them
    (the largest |g| for inf); returns the total.  Row-sparse gradients
    are densified first.  ``error_if_nonfinite`` is taken and, as in the
    reference, checks nothing."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    for p in params:
        p.grad = dense_grad(p.grad)
    grads = [p.grad for p in params]
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([torch.sum(g.abs() ** norm_type)
                             for g in grads]).sum() ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / total.clamp_min(1e-6), max=1.0)
    with torch.no_grad():
        for g in grads:
            g.mul_(scale.to(g.dtype))
    return total


_global_gradient_clip = None


def set_gradient_clip(clip, param_list=None, program=None):
    """The clip of every optimizer built without a ``grad_clip``.  A
    per-parameter list belongs to static programs and is refused, as the
    reference refuses it."""
    global _global_gradient_clip
    if param_list is not None:
        raise NotImplementedError(
            "set_gradient_clip: per-param clip lists are a static-program "
            "construct — pass grad_clip to the optimizer instead")
    _global_gradient_clip = clip


class ErrorClipByValue:
    """Clips a tensor's gradient to [min, max] in the backward:
    ``apply(tensor)`` registers the hook and returns the tensor."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def apply(self, tensor):
        tensor.register_hook(lambda g: g.clamp(self.min, self.max))
        return tensor
