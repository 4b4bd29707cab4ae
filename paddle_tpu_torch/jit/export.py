"""Inference artifacts: ``jit.save`` / ``jit.load`` (port of
paddle_tpu/jit/__init__.py's ``save`` / ``load`` / ``InputSpec`` /
``TranslatedLayer``).

An artifact is three files under one prefix, as the reference writes them:

- ``<prefix>.pdiparams.npz``: the layer's state by its state names (numpy
  arrays; bfloat16 as ml_dtypes' ``bfloat16``), the reference's keys and
  values, so either framework's loader reads the other's weights;
- ``<prefix>.pdmeta``: a pickled dict with the reference's keys —
  ``class``, ``input_spec`` as ``[(shape with -1, numpy dtype name)]``,
  ``op_versions`` (the registry entries of the op families the layer
  uses), and ``export_fallback`` / ``export_error`` when the export
  degraded or failed;
- ``<prefix>.pdmodel`` (only with ``input_spec``): a ``torch.export``
  archive (``torch.export.save``) where the reference writes StableHLO.
  Like the reference's, the program is a pure function of (state,
  inputs): it holds no weights, and ``load`` feeds it the npz's.  A
  ``-1`` dimension is a ``torch.export.Dim`` named by axis position
  (``b`` for dim 0, ``d<j>`` otherwise) and shared across inputs, as the
  reference names its symbolic dimensions; when the symbolic export fails
  the save falls back to concrete shapes (every -1 = 1), with the
  reference's warning and ``meta["export_fallback"]``.

The kernels an exported forward reaches are operators
(``ops/_library.py``): the program keeps one node per call, and running
it launches the kernel on the card (counted in the wrapper's
``.launches``) or the plain version for CPU tensors.  A reference
``.pdmodel`` (StableHLO) is refused with ``ArtifactFormatError``.
"""
from __future__ import annotations

import os
import pickle
import warnings
import zipfile
from typing import Dict

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.errors import InvalidArgumentError
from ..utils import op_version
from ..weights import dtype_name, host_array, host_tensor

__all__ = ["InputSpec", "save", "load", "TranslatedLayer",
           "ArtifactFormatError"]


class ArtifactFormatError(InvalidArgumentError):
    """The ``.pdmodel`` is not a ``torch.export`` archive (for example the
    reference's StableHLO program)."""


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    return getattr(torch, name)


class InputSpec:
    """paddle.static.InputSpec equivalent: a shape (-1 or None for a
    dimension the artifact takes at any size) and a dtype."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(-1 if s is None else int(s) for s in shape)
        self.dtype = _torch_dtype(dtype)
        self.name = name

    def example(self, device, size: int = 2) -> torch.Tensor:
        """A zero tensor of the spec's shape, each -1 taken as ``size``."""
        shape = tuple(size if s == -1 else s for s in self.shape)
        return torch.zeros(shape, dtype=self.dtype, device=device)


def _relevant_op_versions(layer) -> Dict[str, int]:
    """The registry entries of the op families this layer tree exercises,
    by its sublayers' class names, as the reference picks them."""
    relevant = {"exported_program"}
    for _, sub in layer.named_modules():
        if sub is layer:
            continue
        name = type(sub).__name__
        if name in ("MultiHeadAttention", "TransformerEncoderLayer",
                    "TransformerDecoderLayer", "BertLayer", "GPTBlock",
                    "ErnieLayer"):
            relevant |= {"flash_attention", "scaled_dot_product_attention"}
        if name.startswith("Quanted") or name.startswith("Int8"):
            relevant.add("fake_quantize")
        if name.startswith("BatchNorm") or name == "SyncBatchNorm":
            relevant.add("fused_bn_act")
    snap = op_version.snapshot()
    return {k: v for k, v in snap.items() if k in relevant}


class _Pure(torch.nn.Module):
    """``layer``'s forward as a function of (state, *inputs): the exported
    program reads its weights from its inputs and holds none.  The layer
    is kept outside the module tree, so nothing of it is lifted."""

    def __init__(self, layer):
        super().__init__()
        object.__setattr__(self, "_layer", layer)

    def forward(self, state, *args):
        return torch.func.functional_call(self._layer, state, args)


def _export(layer, state, specs, symbolic: bool):
    device = next(iter(state.values())).device if state else torch.device(
        "cpu")
    args = tuple(s.example(device, 2 if symbolic else 1) for s in specs)
    dims = {}
    shapes = None
    if symbolic:
        def dyn(s):
            return {j: dims.setdefault(n, torch.export.Dim(n))
                    for j, d in enumerate(s.shape) if d == -1
                    for n in ["b" if j == 0 else f"d{j}"]} or None
        shapes = ({k: None for k in state}, tuple(dyn(s) for s in specs))
    with torch.no_grad():
        return torch.export.export(_Pure(layer), (state,) + args,
                                   dynamic_shapes=shapes)


def save(layer, path, input_spec=None, **config):
    """paddle.jit.save: the weights (npz), the metadata and, with
    ``input_spec``, the layer's eval forward as a ``torch.export``
    program (module docstring)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sd = layer.state_dict()
    np.savez(path + ".pdiparams.npz",
             **{k: host_array(v) for k, v in sd.items()})
    meta = {"class": type(layer).__name__, "input_spec": None,
            "op_versions": _relevant_op_versions(layer)}
    if input_spec is not None:
        layer.eval()
        specs = [s if isinstance(s, InputSpec)
                 else InputSpec(tuple(s.shape), s.dtype) for s in input_spec]
        state = {k: v.detach() for k, v in sd.items()}
        symbolic = any(d == -1 for s in specs for d in s.shape)
        try:
            try:
                ep = _export(layer, state, specs, symbolic)
            except Exception as sym_err:
                if not symbolic:
                    raise
                # the model is not shape-polymorphic: fall back to the
                # concrete export (every -1 becomes 1), loudly
                warnings.warn(
                    "jit.save: symbolic-shape export failed "
                    f"({type(sym_err).__name__}); falling back to CONCRETE "
                    "shapes — the saved model only accepts the exact "
                    "fallback shapes (every -1 dim = 1)")
                meta["export_fallback"] = f"concrete: {sym_err}"[:500]
                symbolic = False
                ep = _export(layer, state, specs, symbolic)
            ep.example_inputs = None   # the weights stay in the npz only
            with open(path + ".pdmodel", "wb") as f:
                torch.export.save(ep, f)
            meta["input_spec"] = [
                (tuple(d if symbolic else (1 if d == -1 else d)
                       for d in s.shape), dtype_name(s.dtype))
                for s in specs]
        except Exception as e:  # the artifact keeps weights and metadata
            meta["export_error"] = str(e)
    with open(path + ".pdmeta", "wb") as f:
        pickle.dump(meta, f)


class TranslatedLayer:
    """A loaded inference artifact: call it with the inputs of its
    ``input_spec`` (tensors or numpy arrays); they go to the artifact's
    device, and the program runs on them with the npz's weights."""

    def __init__(self, exported, state, meta=None, *, device=None):
        self._exported = exported
        self._module = exported.module()
        self._state = state
        self._meta = meta or {}
        self.device = device

    def __call__(self, *args):
        raw = tuple(torch.as_tensor(a).to(self.device) for a in args)
        with torch.no_grad():
            return self._module(self._state, *raw)

    def eval(self):
        return self

    def train(self):
        return self


def load(path, device=DEFAULT_DEVICE, **config) -> TranslatedLayer:
    """paddle.jit.load: check the artifact's ``op_versions`` against this
    runtime (``strict_op_versions=True`` refuses unknown ops too), read
    the weights onto ``device`` (default the card) and the program.  A
    ``.pdmodel`` that is not a ``torch.export`` archive raises
    ``ArtifactFormatError``; an artifact saved without ``input_spec``
    raises ``FileNotFoundError``."""
    with open(path + ".pdmeta", "rb") as f:
        meta = pickle.load(f)
    op_version.check_compat(meta.get("op_versions"),
                            strict=config.get("strict_op_versions", False))
    dev = resolve_device(device)
    model_file = path + ".pdmodel"
    if not os.path.exists(model_file):
        raise FileNotFoundError(
            f"{model_file} not found — layer was saved without input_spec; "
            "load weights via paddle_tpu_torch.load_paddle_state instead")
    if not zipfile.is_zipfile(model_file):
        raise ArtifactFormatError(
            f"{model_file} is not a torch.export archive (a StableHLO "
            "program of the JAX framework?): re-export the layer with "
            "paddle_tpu_torch.jit.save; its .pdiparams.npz weights load "
            "into a port model through load_paddle_state")
    # the operators the program calls are defined by their wrappers' modules
    from ..ops import flash_attention, int8_matmul  # noqa: F401
    with open(model_file, "rb") as f:
        exported = torch.export.load(f)
    from torch.export.passes import move_to_device_pass
    exported = move_to_device_pass(exported, dev)
    with np.load(path + ".pdiparams.npz") as data:
        state = {k: host_tensor(data[k]).to(dev) for k in data.files}
    return TranslatedLayer(exported, state, meta, device=dev)

