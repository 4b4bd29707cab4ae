"""linear, dropout, embedding and interpolate (counterparts of
paddle_tpu/nn/functional/common.py)."""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...amp import amp_cast, promote
from ...core import rng
from ...core.errors import InvalidArgumentError

__all__ = ["linear", "dropout", "embedding", "interpolate", "upsample"]


def linear(x, weight, bias=None, name=None):
    """y = x @ weight + bias with Paddle's (in, out) weight layout; AMP
    white-listed as ``linear`` with the bias cast too, so that under O1
    the output stays in the low type."""
    x, weight, bias = promote(*amp_cast("linear", x, weight, bias))
    y = x @ weight
    return y if bias is None else y + bias


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Dropout with the reference's parameters.  The keep mask is drawn
    with ``bernoulli_`` from the current generator of ``core.rng`` (never
    torch's global one), so the same generator seed gives the same mask.
    ``axis`` (an int or a list) draws the mask over those axes only and
    broadcasts it over the others.  ``"upscale_in_train"`` scales the kept
    values by 1 / (1 - p); ``"downscale_in_infer"`` keeps them as they are.
    (Inside ``core.rng.keyed_scope`` the mask comes from the scope's key.)
    Out of training (or with p 0) either mode returns ``x``, as the
    reference does."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    if not training or p == 0.0:
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = 1.0 - p
    mask = rng.bernoulli(shape, keep, x.device)
    kept = x / keep if mode == "upscale_in_train" else x
    return torch.where(mask, kept, 0.0).to(x.dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the integer ids ``x``; the output rows at
    ``padding_idx`` are zeros, so no gradient reaches that row (the
    reference's ``F.embedding``).  With ``sparse=True`` the weight's
    gradient is row-sparse (``core.selected_rows``): inside a training
    step that collects sparse gradients the lookup goes through its
    context; eagerly, with grad enabled on a weight that requires it, the
    weight's ``.grad`` is a sparse COO tensor of one index per lookup,
    which the optimizers' lazy row update consumes.  As in the reference,
    a sparse weight must only be consumed by lookups."""
    if x.is_floating_point() or x.is_complex():
        raise InvalidArgumentError(
            f"[embedding] ids must be an integer tensor, got dtype "
            f"{x.dtype}")
    if weight.dim() != 2:
        raise InvalidArgumentError(
            f"[embedding] weight must be 2-D (vocab, dim), got shape "
            f"{tuple(weight.shape)}")
    if sparse:
        from ...core import selected_rows as sr
        ctx = sr.current_ctx()
        if ctx is not None:   # inside a step collecting sparse gradients
            if ctx.wants(ctx.name_of(weight)):
                return sr.ctx_embedding(ctx, x, weight, padding_idx)
            # a weight demoted to a dense gradient (the step warned once):
            # the ordinary differentiable lookup below
        elif torch.is_grad_enabled() and weight.requires_grad:
            return sr.eager_sparse_embedding(x, weight, padding_idx)
    out = weight[x]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0,
                          out).to(weight.dtype)
    return out


_RESIZE = {"nearest": "nearest", "bilinear": "linear", "bicubic": "cubic",
           "trilinear": "linear", "linear": "linear", "area": "linear"}


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


@functools.lru_cache(maxsize=256)
def _resize_weights(m: int, n: int, method: str) -> np.ndarray:
    """(m, n) f32 weights resampling m input pixels to n: half-pixel
    centres, the kernel widened by m / n when shrinking (antialiased),
    each column normalised over the taps inside the input, as the
    reference's resize computes them."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(n) / f32(m))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / kernel_scale
    w = (_triangle if method == "linear" else _keys_cubic)(x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def _nearest_index(m: int, n: int) -> np.ndarray:
    f32 = np.float32
    return np.floor((np.arange(n, dtype=f32) + f32(0.5)) * f32(m)
                    / f32(n)).astype(np.int64)


def _out_sizes(spatial, size, scale_factor):
    if size is not None:
        sizes = size if isinstance(size, (list, tuple)) else [size]
        return [int(s) for s in sizes]
    sf = (scale_factor if isinstance(scale_factor, (list, tuple))
          else [scale_factor] * len(spatial))
    return [int(s * f) for s, f in zip(spatial, sf)]


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial dims of ``x`` (NCW / NCHW / NCDHW or
    channels-last) to ``size`` or by ``scale_factor``, as the reference
    does: ``"nearest"`` picks pixel floor((i + 0.5) * in / out);
    ``"bilinear"`` / ``"linear"`` / ``"trilinear"`` / ``"area"`` and
    ``"bicubic"`` (Keys' kernel, a = -0.5) resample with half-pixel
    centres, antialiased when shrinking; ``align_corners=True`` maps the
    corner pixels onto each other and interpolates linearly between the
    two nearest input pixels, whatever the mode but nearest.
    ``align_mode`` is taken and, as in the reference, changes nothing."""
    method = _RESIZE[mode.lower()]
    if not x.is_floating_point() and method != "nearest":
        x = x.to(torch.float32)
    cf = data_format.startswith("NC")
    axes = list(range(2, x.dim())) if cf else list(range(1, x.dim() - 1))
    outs = _out_sizes([x.shape[a] for a in axes], size, scale_factor)
    if len(outs) != len(axes):
        raise ValueError(
            f"interpolate: {len(outs)} output sizes for {len(axes)} "
            f"spatial dims of a {tuple(x.shape)} {data_format} input")
    if align_corners and method != "nearest":
        for ax, n_out in zip(axes, outs):
            n_in = x.shape[ax]
            if n_out == 1 or n_in == 1:
                idx = np.zeros((n_out,), np.float32)
            else:
                idx = np.linspace(0.0, n_in - 1, n_out).astype(np.float32)
            lo = np.floor(idx).astype(np.int64)
            hi = np.minimum(lo + 1, n_in - 1)
            shape = [1] * x.dim()
            shape[ax] = n_out
            w = torch.from_numpy(idx - lo).to(x.device, x.dtype).view(shape)
            pick = lambda i: x.index_select(  # noqa: E731
                ax, torch.from_numpy(i).to(x.device))
            x = pick(lo) * (1 - w) + pick(hi) * w
        return x
    for ax, n_out in zip(axes, outs):
        n_in = x.shape[ax]
        if n_in == n_out:
            continue
        if method == "nearest":
            x = x.index_select(ax, torch.from_numpy(
                _nearest_index(n_in, n_out)).to(x.device))
            continue
        w = torch.from_numpy(_resize_weights(n_in, n_out, method)).to(
            x.device, x.dtype)
        x = torch.movedim(torch.movedim(x, ax, -1) @ w, -1, ax)
    return x


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)
