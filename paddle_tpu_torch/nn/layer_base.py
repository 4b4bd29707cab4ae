"""Layer base and ParamAttr (counterparts of paddle_tpu/nn/layer_base.py).

A port layer is a ``torch.nn.Module`` that also speaks Paddle's ``Layer``
API: ``create_parameter`` (with ``ParamAttr`` and the initializers of
``nn.initializer``), ``add_parameter`` / ``add_sublayer``, ``sublayers`` /
``named_sublayers`` in the reference's order, ``state_dict`` /
``set_state_dict`` under the reference's keywords, ``register_buffer(...,
persistable=)``, ``clear_gradients``, ``full_name``, ``astype`` and
forward pre / post hooks whose handles have ``.remove()``.

``parameters``, ``buffers``, ``state_dict`` and ``register_buffer`` are
``nn.Module``'s own methods too, and torch calls them with its own
keywords (``recurse=``, ``prefix=``, ``keep_vars=``, ``persistent=``):
each override takes both spellings, and a torch-style call gets what
``nn.Module`` returns.  ``parameters()`` / ``buffers()`` return a list,
as the reference's, that ``next()`` also walks, as torch's generator.

What the port keeps from Paddle is the state naming: parameter and
buffer names are the keys ``paddle_tpu.jit.state_arrays`` (and
``jit.save``'s ``*.pdiparams.npz``) use, so a reference state dict loads
one to one (``weights.py``).  And, as the reference's ``Layer.__call__``,
the call runs a layer that the active ``jit.recompute_policy`` matches as
a checkpoint region inside a ``TrainStep`` forward (``core.recompute``);
it costs one flag test while no policy was ever set.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from ..core import recompute as _recompute
from . import initializer as I

__all__ = ["Layer", "ParamAttr"]


class ParamAttr:
    """paddle.ParamAttr: a parameter's name, initializer, learning-rate
    multiplier, regularizer and flags."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip


def to_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a Paddle / numpy name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(np.dtype(dtype)) if not isinstance(dtype, str) else dtype
    return getattr(torch, name.replace("paddle.", ""))


class _Members(list):
    """The reference's list of parameters (or buffers), which ``next()``
    also walks from the front, as torch's generator."""

    _at = 0

    def __next__(self):
        if self._at >= len(self):
            raise StopIteration
        self._at += 1
        return self[self._at - 1]


def _walk(module, prefix):
    for name, sub in module._modules.items():
        if sub is None:
            continue
        full = f"{prefix}.{name}" if prefix else name
        yield full, sub
        yield from _walk(sub, full)


def _recurse(include_sublayers, recurse):
    return include_sublayers if recurse is None else recurse


class Layer(nn.Module):
    """``nn.Module`` with Paddle's ``Layer`` methods and the device its
    state lives on."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._full_name = name_scope or type(self).__name__.lower()
        self._dtype = to_dtype(dtype)

    def __call__(self, *inputs, **kwargs):
        if _recompute._ENABLED_EVER and _recompute.should_wrap(self):
            return _recompute.run_wrapped(self, inputs, kwargs,
                                          super().__call__)
        return super().__call__(*inputs, **kwargs)

    @property
    def device(self) -> torch.device:
        for t in nn.Module.parameters(self):
            return t.device
        for t in nn.Module.buffers(self):
            return t.device
        return torch.device("cpu")

    # -- construction ---------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None,
                         generator=None):
        """A new parameter of ``shape`` (not registered: assign it).  The
        initializer is the attribute's, else ``set_global_initializer``'s,
        else ``default_initializer``, else the framework's (XavierNormal
        weights, zero biases).  ``attr=False`` gives None.  An attribute's
        name, regularizer and learning rate ride on the parameter
        (``param_name``, ``regularizer``, ``optimize_attr``); ``trainable=False``
        makes it take no gradient.  ``device`` defaults to where the
        layer's state lives; random draws go through ``generator`` when
        given."""
        if attr is False:
            return None
        dtype = to_dtype(dtype) if dtype is not None else getattr(
            self, "_dtype", torch.float32)
        attr_init = name = None
        trainable = True
        given = attr is not None and not isinstance(attr, bool)
        if given:
            attr_init = getattr(attr, "initializer", None)
            name = getattr(attr, "name", None)
            trainable = getattr(attr, "trainable", True)
        global_init = (I._global_bias_init if is_bias
                       else I._global_weight_init)
        init = (attr_init or global_init or default_initializer
                or (I.default_bias_init() if is_bias
                    else I.default_weight_init()))
        if device is None:
            device = self.device
        data = init(shape, dtype, device, generator)
        p = nn.Parameter(data, requires_grad=bool(trainable))
        if name is not None:
            p.param_name = name   # torch's Tensor.name cannot be set
        if given:
            p.regularizer = getattr(attr, "regularizer", None)
            p.optimize_attr = {
                "learning_rate": getattr(attr, "learning_rate", 1.0)}
        return p

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        """Paddle's ``persistable`` or torch's ``persistent``: a buffer
        that is not persistable stays out of ``state_dict``."""
        keep = persistable if persistent is None else persistent
        super().register_buffer(name, tensor, persistent=bool(keep))
        return tensor

    # -- iteration ------------------------------------------------------
    def parameters(self, include_sublayers=True, *, recurse=None):
        return _Members(super().parameters(
            _recurse(include_sublayers, recurse)))

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, *, recurse=None):
        return super().named_parameters(
            prefix, _recurse(include_sublayers, recurse), remove_duplicate)

    def buffers(self, include_sublayers=True, *, recurse=None):
        return _Members(super().buffers(_recurse(include_sublayers,
                                                 recurse)))

    def named_buffers(self, prefix="", include_sublayers=True,
                      remove_duplicate=True, *, recurse=None):
        return super().named_buffers(
            prefix, _recurse(include_sublayers, recurse), remove_duplicate)

    def sublayers(self, include_self=False):
        return [layer for _, layer in
                self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        """(name, layer) pairs depth first, each layer before its own
        sublayers, as the reference walks them."""
        if include_self:
            yield prefix, self
        yield from _walk(self, prefix)

    # -- state ----------------------------------------------------------
    def state_dict(self, *args, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, prefix=None,
                   keep_vars=False):
        """The reference's ``state_dict(destination, include_sublayers,
        structured_name_prefix)`` (parameters, then persistable buffers)
        or, called torch's way (no arguments, ``prefix=``,
        ``keep_vars=``), ``nn.Module.state_dict``.  Keys are the same
        either way."""
        torch_call = (prefix is not None or keep_vars
                      or (len(args) > 1 and isinstance(args[1], str)))
        if torch_call or (not args and include_sublayers
                          and not structured_name_prefix):
            return super().state_dict(*args, destination=destination,
                                      prefix=prefix or "",
                                      keep_vars=keep_vars)
        # the reference's positional form
        names = ("destination", "include_sublayers",
                 "structured_name_prefix", "use_hook")
        given = dict(zip(names, args))
        destination = given.get("destination", destination)
        include_sublayers = given.get("include_sublayers", include_sublayers)
        structured_name_prefix = given.get("structured_name_prefix",
                                           structured_name_prefix)
        dest = OrderedDict() if destination is None else destination
        base = structured_name_prefix.rstrip(".")
        for name, p in self.named_parameters(
                prefix=base, include_sublayers=include_sublayers):
            dest[name] = p.detach()
        layers = [(base, self)]
        if include_sublayers:
            layers += list(self.named_sublayers(prefix=base))
        for name, layer in layers:
            skip = getattr(layer, "_non_persistent_buffers_set", ())
            for bname, b in layer._buffers.items():
                if b is None or bname in skip:
                    continue
                dest[f"{name}.{bname}" if name else bname] = b.detach()
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (tensors, arrays, or the
        reference's tensors) into this layer's parameters and persistable
        buffers in place, cast to their types; a shape mismatch raises.
        Returns (missing keys, unexpected keys).  Keys are structured
        names either way, as the reference matches them."""
        from ..weights import host_tensor
        own = self.state_dict(keep_vars=True)
        missing, unexpected = [], []
        with torch.no_grad():
            for k, v in state_dict.items():
                if k not in own:
                    unexpected.append(k)
                    continue
                tgt = own[k]
                src = (v.detach() if isinstance(v, torch.Tensor)
                       else host_tensor(np.asarray(v)))
                if tuple(src.shape) != tuple(tgt.shape):
                    raise ValueError(
                        f"shape mismatch for {k}: got {tuple(src.shape)}, "
                        f"expected {tuple(tgt.shape)}")
                tgt.copy_(src.to(device=tgt.device, dtype=tgt.dtype))
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- misc -------------------------------------------------------------
    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def full_name(self):
        return getattr(self, "_full_name", type(self).__name__.lower())

    def astype(self, dtype):
        """Cast floating parameters and buffers to ``dtype``."""
        dt = to_dtype(dtype)
        self._dtype = dt
        return self.to(dtype=dt)

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)`` after each forward; a non-None
        return replaces the output.  The handle's ``remove()`` takes it
        off.  (``register_forward_pre_hook`` is torch's, with the
        reference's ``hook(layer, inputs)``.)"""
        return self.register_forward_hook(hook)
