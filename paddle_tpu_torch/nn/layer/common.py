"""Linear, Embedding, the dropouts, Upsample, the pads and the shape
layers (counterparts of paddle_tpu/nn/layer/common.py).

Each layer takes the reference's parameters in the reference's order;
the port's own ``std`` / ``device`` / ``generator`` come after them, as
keywords.  Parameters are made by ``Layer.create_parameter`` on
``device``: the attribute's initializer if ``weight_attr`` / ``bias_attr``
carries one, else ``Normal(0, std)`` when ``std`` is given, else the
reference's default (XavierNormal for ``Linear``, Normal(0, 1) for
``Embedding``, zero biases).  ``bias_attr=False`` means no bias.  Random
draws go through ``generator`` when given (models pass a seeded one).

``Linear`` keeps Paddle's weight layout, (in_features, out_features), and
computes ``x @ weight + bias``, so reference weights load without a
transpose; it goes through ``F.linear``, so AMP casts it.  ``Dropout``
draws its mask from an explicit generator (``core.rng``), never from
torch's global one.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer, ParamAttr

__all__ = ["Identity", "Linear", "Embedding", "Dropout", "Dropout2D",
           "Dropout3D", "AlphaDropout", "Flatten", "Upsample",
           "UpsamplingNearest2D", "UpsamplingBilinear2D", "Pad1D", "Pad2D",
           "Pad3D", "ZeroPad2D", "CosineSimilarity", "PairwiseDistance",
           "Bilinear", "PixelShuffle", "PixelUnshuffle", "ChannelShuffle",
           "Unfold", "Fold"]


def with_std(attr, std):
    """``attr`` with ``Normal(0, std)`` as its initializer when ``std`` is
    given and the attribute names none (``False`` stays ``False``)."""
    if std is None or attr is False or getattr(attr, "initializer", None):
        return attr
    if attr is None:
        return ParamAttr(initializer=I.Normal(0.0, std))
    return ParamAttr(attr.name, I.Normal(0.0, std), attr.learning_rate,
                     attr.regularizer, attr.trainable,
                     attr.do_model_average, attr.need_clip)


class Linear(Layer):
    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 std: Optional[float] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.weight = self.create_parameter(
            (self.in_features, self.out_features),
            attr=with_std(weight_attr, std),
            default_initializer=I.XavierNormal(), device=device,
            generator=generator)
        self.bias = self.create_parameter(
            (self.out_features,), attr=bias_attr, is_bias=True,
            device=device, generator=generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(Layer):
    """The reference's ``Embedding``: a (num_embeddings, embedding_dim)
    table looked up by ``F.embedding``.  A negative ``padding_idx`` counts
    from the end; that row alone is zeroed at construction, and the lookup
    zeroes its output rows, so it never takes a gradient.
    ``sparse=True`` marks the weight ``sparse_grad``: its gradient is
    row-sparse (eagerly a sparse COO ``.grad``; in ``jit.TrainStep`` the
    step's lazy row update), as the reference's SelectedRows."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse=False, weight_attr=None, name=None,
                 *, std: Optional[float] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.padding_idx = (None if padding_idx is None else
                            padding_idx if padding_idx >= 0 else
                            self.num_embeddings + padding_idx)
        self.sparse = sparse
        self.weight = self.create_parameter(
            (self.num_embeddings, self.embedding_dim),
            attr=with_std(weight_attr, std),
            default_initializer=I.Normal(0.0, 1.0), device=device,
            generator=generator)
        if self.padding_idx is not None:
            with torch.no_grad():
                self.weight[self.padding_idx] = 0.0
        if sparse:
            self.weight.sparse_grad = True

    def forward(self, ids):
        return F.embedding(ids, self.weight, padding_idx=self.padding_idx,
                           sparse=self.sparse)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    """The reference's ``Dropout(p, axis, mode)``.  The mask comes from the
    current generator of ``core.rng`` (the training step's, inside
    ``TrainStep``)."""

    def __init__(self, p: float = 0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        self.p = float(p)
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Upsample(Layer):
    """``F.interpolate`` with the layer's size or scale, mode, corner
    alignment and layout."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class Identity(Layer):
    def forward(self, x):
        return x


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        from ...tensor.manipulation import flatten
        return flatten(x, self.start_axis, self.stop_axis)


class Pad1D(Layer):
    """``F.pad`` with the layer's widths, mode, value and layout."""

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__()
        self.padding, self.mode = padding, mode
        self.value, self.data_format = value, data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad2D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Bilinear(Layer):
    """``weight`` (out, in1, in2), XavierNormal by default as the
    reference's, and ``bias`` (out,)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features), attr=weight_attr,
            device=device, generator=generator)
        self.bias = self.create_parameter(
            (out_features,), attr=bias_attr, is_bias=True, device=device,
            generator=generator)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)
