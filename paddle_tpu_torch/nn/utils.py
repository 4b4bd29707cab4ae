"""weight_norm, remove_weight_norm and spectral_norm (counterpart of
paddle_tpu/nn/utils.py).

Both reparameterizations are forward pre-hooks over the reference's
parameter names: ``weight_norm`` replaces ``<name>`` by the trainable
``<name>_v`` (the direction, the weight's shape) and ``<name>_g`` (the
norm, 1-D of the weight's extent on ``dim``, a scalar for ``dim=None``),
and rebuilds ``<name> = g * v / ||v||`` (the norm over every axis but
``dim``) before each forward; ``spectral_norm`` keeps ``<name>_orig`` and
divides it by its leading singular value, estimated by power iteration
from a unit vector u (numpy ``RandomState(0)``, as the reference draws
it) that persists between calls.  u and v are constants of the backward;
sigma = u^T W v stays in it, so the gradient of W carries the
-(u v^T) / sigma term, as Paddle's.  While a CUDA graph is being captured
u is not written back (the captured step replays the captured u, as the
reference's traced step bakes in its u).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm"]


def _norm_except(v, dim):
    if dim is None:
        return torch.sqrt(torch.sum(v * v))
    axes = [i for i in range(v.dim()) if i != dim]
    return torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))


def weight_norm(layer, name="weight", dim=0):
    """Reparameterize ``layer.<name>`` as g * v / ||v||."""
    w = getattr(layer, name).detach().to(torch.float32)
    if dim is not None:
        dim = dim % w.dim()
    g0 = _norm_except(w, dim).reshape(() if dim is None else (w.shape[dim],))
    del layer._parameters[name]
    setattr(layer, name + "_v", nn.Parameter(w.clone()))
    setattr(layer, name + "_g", nn.Parameter(g0.clone()))

    def rebuild(lyr, inputs):
        v = getattr(lyr, name + "_v")
        g = getattr(lyr, name + "_g")
        if dim is not None:
            shape = [1] * v.dim()
            shape[dim] = -1
            g = g.reshape(shape)
        object.__setattr__(lyr, name, g * v / _norm_except(v, dim))

    handle = layer.register_forward_pre_hook(rebuild)
    layer.__dict__["_weight_norm_hook_" + name] = (handle, rebuild)
    rebuild(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Bake the current g and v back into a plain ``<name>`` parameter."""
    entry = layer.__dict__.pop("_weight_norm_hook_" + name, None)
    if entry is None:
        raise ValueError(f"no weight norm on {name!r}")
    handle, rebuild = entry
    rebuild(layer, None)
    handle.remove()
    eff = getattr(layer, name).detach().clone()
    for suffix in ("_v", "_g"):
        del layer._parameters[name + suffix]
    setattr(layer, name, nn.Parameter(eff))
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=0):
    """Divide ``layer.<name>`` by its leading singular value before each
    forward (``<name>_orig`` is the trainable tensor)."""
    w = getattr(layer, name).detach().to(torch.float32)
    rows = w.shape[dim]
    u0 = np.random.RandomState(0).randn(rows).astype("float32")
    u0 = u0 / (np.linalg.norm(u0) + eps)
    layer.__dict__["_sn_u_" + name] = torch.from_numpy(u0).to(w.device)
    del layer._parameters[name]
    setattr(layer, name + "_orig", nn.Parameter(w.clone()))

    def rebuild(lyr, inputs):
        worig = getattr(lyr, name + "_orig")
        m_t = torch.movedim(worig, dim, 0).reshape(rows, -1)
        with torch.no_grad():
            m = m_t.to(torch.float32)
            u = lyr.__dict__["_sn_u_" + name].to(m.device)
            for _ in range(n_power_iterations):
                v = m.T @ u
                v = v / torch.clamp_min(torch.linalg.norm(v), eps)
                u = m @ v
                u = u / torch.clamp_min(torch.linalg.norm(u), eps)
            if not (u.is_cuda and torch.cuda.is_current_stream_capturing()):
                lyr.__dict__["_sn_u_" + name] = u
        sigma = u[None, :] @ (m_t @ v[:, None])
        object.__setattr__(lyr, name, worig / sigma.reshape(()))

    handle = layer.register_forward_pre_hook(rebuild)
    layer.__dict__["_spectral_norm_hook_" + name] = (handle, rebuild)
    rebuild(layer, None)
    return layer
