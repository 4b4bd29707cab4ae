"""paddle_tpu_torch: the PyTorch / CUDA (H100) port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module layout and never imports it (nor ``jax``).  Hot paths that the
reference wrote as Pallas TPU kernels are hand-written CUDA kernels here
(``csrc/``), built on first use; each sits beside its plain PyTorch
version, which runs for CPU tensors.  Entry points run on the card unless
the caller passes ``device="cpu"``.
"""
from . import (amp, distributed, generation, inference, jit,  # noqa: F401
               lora, models, nn, observability, optimizer, parallel,
               programs, quantization, regularizer, serving, vision)
from .core.rng import seed  # noqa: F401
from .nn.layer_base import ParamAttr  # noqa: F401
from .weights import load_paddle_opt_state, load_paddle_state  # noqa: F401

__all__ = ["amp", "distributed", "generation", "inference", "jit", "lora",
           "models", "nn", "observability", "optimizer", "parallel",
           "programs",
           "quantization", "regularizer",
           "serving", "vision", "seed", "ParamAttr", "load_paddle_state",
           "load_paddle_opt_state"]

programs.bootstrap()
