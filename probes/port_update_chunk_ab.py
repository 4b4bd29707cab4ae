"""A/B of paddle_tpu_torch's train-step optimizer update on one CUDA card.

    python3 probes/port_update_chunk_ab.py [--seed N] [--steps N]

GPT-2 medium (24 x 1024, vocab 50304), B 4 x S 1024, O1 bf16, AdamW(1e-4),
dropout 0.1, through ``jit.TrainStep``'s captured step (chip_smoke.py's
train phase), in turns A, B, B, A in one process:
  A: the update written in place by chunks of
     ``optimizer.functional._CHUNK`` elements (the shipped setting);
  B: one chunk holding every parameter (the update's arithmetic and
     in-place writes unchanged, its temporaries those of the whole state).
Each turn builds the model and the step from the seed, captures the step
(warmup), runs 3 steps, then times ``--steps`` steps by CUDA events (device
ms per step, the host is not in the way of a replayed step), and reads
the peak memory of one uncaptured step.  Prints the card's name and power
limit, one line per turn, and the losses of each turn (equal in every
turn: the chunking changes no value).
"""
from __future__ import annotations

import argparse
import gc
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repo


def turn(torch, args, chunk: int):
    import numpy as np

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion,
                                         gpt2_medium_config)
    from paddle_tpu_torch.optimizer import functional
    functional._CHUNK = chunk
    dev = torch.device("cuda", 0)
    cfg = gpt2_medium_config()
    pt.seed(args.seed)
    model = GPTForPretraining(cfg, device=dev, seed=args.seed)
    crit = GPTPretrainingCriterion()
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters())
    step = TrainStep(model, lambda logits, y: crit(logits, y), opt,
                     amp_level="O1", amp_dtype="bfloat16")
    rng = np.random.RandomState(args.seed)
    batch = tuple(torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 1024)))
                  .to(dev) for _ in range(2))
    step.warmup(*batch)
    losses = [float(step(*batch)) for _ in range(3)]
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(args.steps):
        step(*batch)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / args.steps
    step._run_uncaptured = True
    torch.cuda.reset_peak_memory_stats()
    step(*batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, step, opt
    gc.collect()
    torch.cuda.empty_cache()
    return ms, peak, losses


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("port_update_chunk_ab: no CUDA device is available")
    from paddle_tpu_torch.optimizer import functional
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    settings = {"A": functional._CHUNK, "B": 1 << 40}
    for name in "ABBA":
        ms, peak, losses = turn(torch, args, settings[name])
        print(f"turn {name} (chunk {settings[name]}): {ms:.3f} ms per "
              f"captured step (device, {args.steps} steps), peak memory of "
              f"an uncaptured step {peak:.2f} GiB; losses "
              + ", ".join(repr(x) for x in losses))


if __name__ == "__main__":
    main()
