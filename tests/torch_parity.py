"""Shared helpers of the tests/test_torch_*.py parity tests: the same tiny
GPT in the JAX package and in paddle_tpu_torch, its weights carried across
by name with ``load_paddle_state``."""
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.jit import state_arrays

from paddle_tpu_torch import load_paddle_state
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

# tiny shapes gain nothing from intra-op threads, and idle OpenMP threads
# spinning would take cores from the test files running beside these
torch.set_num_threads(1)

# 2 layers, hidden 64, 4 heads, vocab 128; a wide init keeps greedy
# argmaxes well separated, so a 1e-6 difference in summation order
# cannot flip a token
TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, max_position_embeddings=64,
            initializer_range=0.2)


def jax_state(model):
    return {k: np.asarray(v) for k, v in state_arrays(model).items()}


def tiny_pair(seed=1, quantize=False):
    """(jax model, port model) with identical weights, both in eval mode;
    with ``quantize`` both are int8 weight-only (quantized by the JAX
    package, the int8 buffers carried across)."""
    paddle.seed(seed)
    jm = jmodels.GPTForPretraining(jmodels.GPTConfig(**TINY))
    jm.eval()
    tm = GPTForPretraining(GPTConfig(**TINY), device="cpu").eval()
    if quantize:
        from paddle_tpu.quantization import quantize_for_serving as jq
        from paddle_tpu_torch.quantization import quantize_for_serving
        jq(jm)
        quantize_for_serving(tm)
    load_paddle_state(tm, jax_state(jm))
    return jm, tm


def jax_solo(model, prompt, max_new):
    out, _ = model.generate(paddle.to_tensor(
        np.asarray(prompt, np.int32)[None]), max_new_tokens=max_new)
    return np.asarray(out.numpy())[0].tolist()


def torch_solo(model, prompt, max_new):
    from paddle_tpu_torch.generation import generate
    out, _ = generate(model, torch.as_tensor(np.asarray(prompt)[None]),
                      max_new_tokens=max_new, device="cpu")
    return out[0].tolist()
