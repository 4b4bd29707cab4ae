"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py).

Each clip maps a list of (param, grad) pairs to a new one; the eager
``Optimizer.step`` applies its ``grad_clip``.  ``jit.TrainStep`` applies
none, like the reference's compiled step.  A row-sparse gradient is
densified first (norms need the merged rows; the reference likewise
densifies sparse gradients before a clip).
"""
from __future__ import annotations

import torch

from ..core.selected_rows import dense_grad

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


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
