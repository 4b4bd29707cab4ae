"""paddle.inference — Config / Predictor deployment API (port of
paddle_tpu/inference/__init__.py).

Configure a saved model, create a predictor, feed named input handles,
run, read named output handles:

- ``Predictor`` runs a ``jit.save`` artifact's exported program
  (``jit.load``: a ``torch.export`` program over the npz weights) on the
  card, or on the CPU after ``Config.disable_gpu()``;
- ``ServingPredictor`` (``Config.enable_serving``) fronts a
  continuous-batching ``serving.ServingEngine`` — and, with ``gateway=``,
  the multi-tenant ``serving.ServingGateway`` and its HTTP endpoint —
  behind the predictor surface; a ``model_provider`` model takes its
  weights from ``<prefix>.pdiparams.npz`` (either framework's).

The pass / optimization knobs (ir_optim, memory_optim, mkldnn, TensorRT)
are accepted and recorded, as the reference records them.
``enable_profile`` wires the profiler around ``run()`` and turns on the
serving engine's spans.  ``enable_serving(program_cache_dir=)`` turns the
program store on, ``program_set=`` boots the engine from a program set
(``ServingPredictor.save_program_set``); a set the engine rejects is a
warning, a count of ``program_set_fallback_total`` and a fresh boot.
``enable_recsys_serving`` routes ``create_predictor`` to
``embedding.RecsysPredictor`` (micro-batched deduped CTR scoring).  Not
ported, and refused with ``UnimplementedError``: ``enable_xpu`` devices.

    pred = create_predictor(Config(prefix).enable_serving(
        model_provider=build_gpt, quantize="int8", kv="paged"))
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.errors import UnimplementedError

__all__ = ["Config", "Predictor", "PredictorTensor", "ServingPredictor",
           "create_predictor"]

class Config:
    """AnalysisConfig equivalent.  The device defaults to the card
    (``enable_use_gpu(device_id=)`` picks ``cuda:<id>``); ``disable_gpu()``
    runs on the CPU."""

    def __init__(self, model_path: Optional[str] = None,
                 params_path: Optional[str] = None):
        # one artifact prefix covers program and weights (jit.save layout)
        self._prefix = None
        if model_path is not None:
            self.set_model(model_path, params_path)
        self._ir_optim = True
        self._memory_optim = False
        self._profile = False
        self._device = "gpu"
        self._device_id = 0
        self._threads = 1
        self._serving = None
        self._recsys = None

    # -- model ----------------------------------------------------------------
    def set_model(self, model_path: str, params_path: Optional[str] = None):
        for suffix in (".pdmodel", ".pdiparams", ".pdiparams.npz"):
            if model_path.endswith(suffix):
                model_path = model_path[:-len(suffix)]
                break
        if params_path is not None:
            # jit.save artifacts keep program and weights under one prefix;
            # a divergent params location cannot be honored
            expect = model_path + ".pdiparams"
            stripped = params_path[:-4] if params_path.endswith(".npz") \
                else params_path
            if stripped != expect:
                raise ValueError(
                    f"params_path {params_path!r} disagrees with the "
                    f"artifact prefix {model_path!r} (expected "
                    f"{expect}[.npz]); artifacts store weights next to the "
                    "program")
        self._prefix = model_path

    def model_dir(self):
        return self._prefix

    # -- device ---------------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = "gpu"
        self._device_id = int(device_id)
        return self

    def disable_gpu(self):
        self._device = "cpu"
        return self

    def enable_xpu(self, *a, **k):
        # recorded as the reference records it; create_predictor refuses it
        self._device = "xpu"
        return self

    def use_gpu(self):
        return self._device == "gpu"

    def torch_device(self) -> str:
        """The torch device the predictor runs on."""
        if self._device == "xpu":
            raise UnimplementedError(
                "Config.enable_xpu(): the port runs on an NVIDIA card or the "
                "CPU; call enable_use_gpu() or disable_gpu()")
        return f"cuda:{self._device_id}" if self._device == "gpu" else "cpu"

    def set_cpu_math_library_num_threads(self, n: int):
        self._threads = int(n)

    # -- optimization knobs (recorded) -----------------------------------------
    def switch_ir_optim(self, flag: bool = True):
        self._ir_optim = bool(flag)

    def ir_optim(self):
        return self._ir_optim

    def enable_memory_optim(self, flag: bool = True):
        self._memory_optim = bool(flag)

    def memory_optim_enabled(self):
        return self._memory_optim

    def enable_tensorrt_engine(self, *a, **k):
        pass  # accepted for API compatibility

    def enable_mkldnn(self):
        pass

    def switch_use_feed_fetch_ops(self, flag=False):
        pass

    def switch_specify_input_names(self, flag=True):
        pass

    # -- serving mode ---------------------------------------------------------
    def enable_serving(self, model=None, model_provider=None, **engine_opts):
        """Switch create_predictor() to the continuous-batching
        ``serving.ServingEngine``.  Exactly one of ``model`` (a Layer on the
        Config's device implementing the gen_fixed_cache / forward_fixed
        protocol) or ``model_provider`` (a zero-argument callable building
        one; its weights then come from ``<prefix>.pdiparams.npz``).

        ``engine_opts`` go to ``ServingEngine`` (max_slots, max_len,
        prefill_buckets, kv, block_size, num_blocks, decode_chunk,
        draft_model, spec_tokens, dtype, lora, ...), besides:
        ``quantize="int8"`` (``quantization.quantize_for_serving`` of the
        model, and of the draft, before the engine is built); ``warmup``
        (default True: capture every program first); ``start`` (default
        True: start the loop); ``gateway`` (True or a dict of
        ``ServingGateway`` keyword arguments: the gateway then fronts the
        engine and drives its loop; ``submit`` takes ``tenant=`` /
        ``priority=``, and ``serve_http`` opens the OpenAI-shaped
        endpoint); ``program_cache_dir`` (the program store's directory,
        ``programs.store``); ``program_set`` (boot the engine from a
        saved program set).  Returns the Config."""
        if (model is None) == (model_provider is None):
            raise ValueError(
                "enable_serving needs exactly one of model= (in-memory) or "
                "model_provider= (architecture factory for a saved "
                "artifact)")
        self._serving = {"model": model, "model_provider": model_provider,
                         **engine_opts}
        return self

    def serving_enabled(self) -> bool:
        return self._serving is not None

    def enable_recsys_serving(self, model=None, table=None, offsets=None,
                              **opts):
        """Route ``create_predictor()`` to the batched deduped-lookup CTR
        scorer (``embedding.RecsysPredictor``): ``model`` an
        external-embedding Layer (``models.DLRM(embedding="external")``),
        ``table`` a ``HostEmbeddingTable`` or a (rows, dim) ndarray,
        ``offsets`` the per-feature offsets (``DLRMConfig.offsets``);
        ``opts`` go to the predictor (max_batch, window_ms, max_queue,
        slab_bucket).  The predictor runs on this Config's device."""
        if model is None or table is None:
            raise ValueError(
                "enable_recsys_serving needs model= (external-embedding "
                "Layer) and table= (HostEmbeddingTable or ndarray)")
        self._recsys = {"model": model, "table": table, "offsets": offsets,
                        **opts}
        return self

    def recsys_enabled(self) -> bool:
        return self._recsys is not None

    # -- profiling ------------------------------------------------------------
    def enable_profile(self):
        self._profile = True

    def summary(self) -> str:
        return (f"Config(model={self._prefix!r}, device={self._device}, "
                f"ir_optim={self._ir_optim}, "
                f"memory_optim={self._memory_optim}, "
                f"threads={self._threads}, "
                f"serving={self.serving_enabled()})")


class PredictorTensor:
    """ZeroCopyTensor equivalent: a named input/output slot."""

    def __init__(self, name: str, shape=None, dtype=None):
        self.name = name
        self._shape = tuple(shape) if shape is not None else None
        self._dtype = dtype
        self._value: Optional[np.ndarray] = None

    def copy_from_cpu(self, arr: np.ndarray):
        arr = np.asarray(arr)
        if self._dtype is not None:
            arr = arr.astype(self._dtype, copy=False)
        self._value = arr

    def copy_to_cpu(self) -> np.ndarray:
        if self._value is None:
            raise RuntimeError(f"tensor {self.name!r} has no value yet "
                               "(run() first)")
        return np.asarray(self._value)

    def reshape(self, shape):
        self._shape = tuple(shape)

    def shape(self):
        if self._value is not None:
            return list(self._value.shape)
        return list(self._shape) if self._shape else []


def _leaves(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    return [t for o in out for t in _leaves(o)]


class Predictor:
    """AnalysisPredictor equivalent over a ``jit.save`` artifact: the
    exported program, loaded onto the Config's device."""

    def __init__(self, config: Config):
        from ..jit import load as jit_load
        if config.model_dir() is None:
            raise ValueError("Config has no model path (set_model)")
        self._config = config
        self._layer = jit_load(config.model_dir(),
                               device=config.torch_device())
        specs = (self._layer._meta or {}).get("input_spec") or []
        if not specs:
            raise RuntimeError(
                "artifact has no input_spec metadata; re-export it with "
                "paddle_tpu_torch.jit.save(..., input_spec=[...])")
        self._inputs: Dict[str, PredictorTensor] = {
            f"x{i}": PredictorTensor(f"x{i}", shape, dtype)
            for i, (shape, dtype) in enumerate(specs)}
        self._outputs: Dict[str, PredictorTensor] = {}

    def get_input_names(self) -> List[str]:
        return list(self._inputs)

    def get_input_handle(self, name: str) -> PredictorTensor:
        return self._inputs[name]

    def run(self) -> bool:
        from ..utils.monitor import stat_add
        stat_add("STAT_predictor_runs")
        args = []
        for name, t in self._inputs.items():
            if t._value is None:
                raise RuntimeError(f"input {name!r} not set")
            args.append(t._value)
        prof = None
        if self._config._profile:
            from ..utils import profiler
            prof = profiler.RecordEvent("predictor_run")
            prof.__enter__()
        try:
            out = self._layer(*args)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        from ..weights import host_array
        self._outputs = {}
        for i, leaf in enumerate(_leaves(out)):
            t = PredictorTensor(f"out{i}")
            t.copy_from_cpu(host_array(leaf))
            self._outputs[t.name] = t
        return True

    def get_output_names(self) -> List[str]:
        return list(self._outputs)

    def get_output_handle(self, name: str) -> PredictorTensor:
        return self._outputs[name]

    def profile_report(self) -> Dict:
        """The Config's recorded knobs beside the profiler's spans, the
        monitor counters and ``observability.report()``: the shape
        ``ServingPredictor.profile_report()`` returns too."""
        return _profile_report(self._config)


def _profile_report(config: Config, serving_metrics=None) -> Dict:
    from .. import observability
    from ..utils import profiler
    from ..utils.monitor import stats
    rep = {
        "config": {"model": config._prefix, "device": config._device,
                   "ir_optim": config._ir_optim,
                   "memory_optim": config._memory_optim,
                   "threads": config._threads,
                   "profile": config._profile},
        "op_spans": profiler.summary(),
        "stats": {k: v for k, v in stats().items()
                  if k.startswith("STAT_serving_")
                  or k == "STAT_predictor_runs"},
        "observability": observability.report(),
    }
    if serving_metrics is not None:
        rep["serving"] = serving_metrics
    return rep


class ServingPredictor:
    """Serving-mode predictor: create_predictor(config) returns this when
    ``config.enable_serving(...)`` was called.  It wraps a
    ``serving.ServingEngine`` on the Config's device (programs captured,
    loop started, unless ``warmup=False`` / ``start=False``), fronted by a
    ``serving.ServingGateway`` with ``gateway=``."""

    def __init__(self, config: Config):
        from ..quantization import quantize_for_serving
        from ..serving import ServingEngine, ServingGateway
        from ..weights import load_paddle_state
        opts = dict(config._serving)
        model = opts.pop("model", None)
        provider = opts.pop("model_provider", None)
        warmup = opts.pop("warmup", True)
        start = opts.pop("start", True)
        gateway = opts.pop("gateway", None)
        quantize = opts.pop("quantize", None)
        program_cache_dir = opts.pop("program_cache_dir", None)
        if program_cache_dir is not None:
            from ..programs import store as _pstore
            _pstore.enable(program_cache_dir)
        opts.setdefault("device", config.torch_device())
        if model is None:
            model = provider()
            prefix = config.model_dir()
            if prefix is None:
                raise ValueError(
                    "serving with model_provider= needs a jit.save artifact "
                    "(Config.set_model) to restore weights from")
            with np.load(prefix + ".pdiparams.npz") as data:
                load_paddle_state(model, {k: data[k] for k in data.files})
        model.eval()
        draft = opts.get("draft_model")
        if draft is not None:
            draft.eval()
        if quantize is not None:
            # int8 weight-only before the engine makes any program: the
            # captured set holds int8 from the first capture
            model = quantize_for_serving(model, quantize)
            if draft is not None:
                opts["draft_model"] = quantize_for_serving(draft, quantize)
        self._config = config
        self.engine = self._boot(ServingEngine, model, config, opts)
        if warmup:
            self.engine.warmup()
        self.gateway = None
        if gateway is not None and gateway is not False:
            gw_opts = {} if gateway is True else dict(gateway)
            self.gateway = ServingGateway(self.engine, **gw_opts)
        if start:
            # the gateway owns the engine loop when present (preemption
            # interleaves with engine steps on one thread)
            if self.gateway is not None:
                self.gateway.start()
            else:
                self.engine.start()

    @staticmethod
    def _boot(engine_cls, model, config, opts):
        """The engine; a program set it rejects costs a fresh boot (the
        same kernels, built or found in the store), never an outage: a
        warning and a count of ``program_set_fallback_total``."""
        from ..programs.program_set import ProgramSetError
        try:
            return engine_cls(model, profile=config._profile, **opts)
        except ProgramSetError as e:
            if opts.get("program_set") is None:
                raise
            import warnings
            warnings.warn(
                f"enable_serving(program_set=...): artifact rejected ({e}); "
                "falling back to a fresh boot")
            from ..observability.metrics import counter
            counter("program_set_fallback_total",
                    "serving boots that rejected their program set and "
                    "booted fresh").inc()
            opts = dict(opts, program_set=None)
            return engine_cls(model, profile=config._profile, **opts)

    def submit(self, prompt, max_new_tokens, **kwargs):
        """Enqueue a request; returns the streaming ``serving.Response``.
        With a gateway, kwargs also take ``tenant=`` and ``priority=``, and
        every admission outcome is a terminal Response (shed or
        rate-limited requests come back failed instead of raising)."""
        if self.gateway is not None:
            return self.gateway.submit(prompt, max_new_tokens, **kwargs)
        return self.engine.submit(prompt, max_new_tokens, **kwargs)

    def metrics(self):
        if self.gateway is not None:
            return self.gateway.metrics()
        return self.engine.metrics()

    def save_program_set(self, path: str,
                         extra_meta: Optional[dict] = None) -> str:
        """The engine's program set (``ServingEngine.save_program_set``):
        every replica built with ``enable_serving(..., program_set=path)``
        then boots from it."""
        return self.engine.save_program_set(path, extra_meta)

    def serve_http(self, port: int = 8000, addr: str = "127.0.0.1"):
        """Start the OpenAI-shaped streaming endpoint over the gateway
        (needs gateway= in enable_serving); returns the server
        (``.close()`` stops it)."""
        if self.gateway is None:
            raise ValueError(
                "serve_http needs a gateway: enable_serving(..., "
                "gateway=True) or gateway={...}")
        from ..serving import serve_gateway
        return serve_gateway(self.gateway, port=port, addr=addr)

    def profile_report(self) -> Dict:
        """Config knobs, profiler spans and the live serving metrics in one
        report; with a gateway, its metrics under ``"gateway"``."""
        rep = _profile_report(self._config, self.engine.metrics())
        if self.gateway is not None:
            gm = self.gateway.metrics()
            gm.pop("engine", None)  # already under rep["serving"]
            rep["gateway"] = gm
        return rep

    def close(self):
        if self.gateway is not None:
            self.gateway.close()  # closes the engine too
        else:
            self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def create_predictor(config: Config):
    dev = config.torch_device()   # refuses enable_xpu typed
    if config.recsys_enabled():
        from ..embedding import RecsysPredictor
        opts = dict(config._recsys)
        model = opts.pop("model").to(dev)
        return RecsysPredictor(model, opts.pop("table"),
                               offsets=opts.pop("offsets"), device=dev,
                               **opts)
    if config.serving_enabled():
        return ServingPredictor(config)
    return Predictor(config)
