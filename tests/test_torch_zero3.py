"""ZeRO stage 3 that gathers one unit at a time (parallel.ShardedTrainStep)
on four gloo ranks (``tests/torch_ranks.py``).

Stage 3 gathers each GPT block's parameters only while that block runs
(and again for its backward); the root unit (embeddings, tied head, final
norm) is gathered for the forward.  Its losses and parameters must be
bit-equal to stage 2's, with and without recompute, and the gather's
counter must show at most the root and one block (two at a block
boundary) gathered at once, where the up-front gather held the whole
model.
"""
import os

import numpy as np
import pytest
import torch

import torch_ranks as R
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero3")
    m = GPTForPretraining(GPTConfig(**dict(R.TINY_GPT, num_hidden_layers=4)),
                          device="cpu", seed=3)
    np.savez(os.path.join(out, "gpt4.npz"),
             **{k: v.detach().numpy() for k, v in m.state_dict().items()})
    R.run_group(4, ["stage3_blocks"], out, limit=180.0)
    return out


@pytest.mark.parametrize("remat", ["", "r"])
def test_stage3_bit_equal_to_stage2(group, remat):
    for rank in range(4):
        got = R.result(group, "stage3_blocks", rank)
        assert np.array_equal(got[f"s3{remat}_losses"],
                              got[f"s2{remat}_losses"])
        keys = [k.split(":", 1)[1] for k in got if k.startswith("s2:")]
        assert keys
        for k in keys:
            assert np.array_equal(got[f"s3{remat}:{k}"],
                                  got[f"s2{remat}:{k}"]), k


@pytest.mark.parametrize("remat", ["", "r"])
def test_stage3_gathers_one_block_at_a_time(group, remat):
    got = R.result(group, "stage3_blocks")
    peak = int(got[f"s3{remat}_peak"])
    root, block = int(got["root_bytes"]), int(got["block_bytes"])
    assert 0 < peak <= root + 2 * block
    assert peak < int(got["whole_bytes"])
