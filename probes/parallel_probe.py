"""paddle_tpu_torch's parallel paths across the cards of one host, on NCCL.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4 \\
        probes/parallel_probe.py [--seed N] [--steps N]

One process per card (the launcher's ``PADDLE_*`` variables;
``init_parallel_env`` starts NCCL).  Every rank:

1. holds the tiny GPT of the CPU tests (vocab 64, hidden 32, 2 layers, f32,
   Adam 1e-2, B 8 x S 16, 3 steps) through ``ShardedTrainStep`` under
   ``{"dp": 4}``, ``{"dp": 2, "tp": 2}``, ZeRO-2 and stage 3, and through
   GPipe and 1F1B at ``{"pp": 2, "dp": 2}``, against a single-card
   ``TrainStep`` on the same card (no group): losses within 1e-5
   relative; then ring attention at ``{"dp": 2, "sp": 2}`` against the
   naive softmax (output 2e-4, gradients 2e-3 of |max|);
2. holds the fused BatchNorm over the four cards at ResNet-50's stem
   shape (global (64, 112, 112, 64) NHWC f32, 16 rows per card; on the
   CPU (16, 28, 28, 16)) inside ``stats_group`` of the ``dp`` group,
   against the same call on one card over all the rows: K5 -> all-reduce
   -> K6 and K7 -> all-reduce -> K8 (the pooled form: K9 and its plain
   recompute through the differentiable all-reduce); each rank's rows of
   the output and dx, the statistics, and dgamma / dbeta summed over the
   ranks within 1e-4 of each tensor's largest |value|, at most one
   element in a million past it (the ReLU's kink, as the card test);
   then ResNet-50 (f32, NHWC, Momentum(0.01, 0.9), global batch 64 x
   224^2; on the CPU ResNet-18, 16 x 64^2) through ``ShardedTrainStep``
   under ``{"dp": 4}`` against a one-card ``TrainStep`` on all the rows:
   the first loss within 1e-5 relative, and the first step's parameter
   change (the gradient) no further from the one card's than twice the
   distance between two one-card steps (the fused BatchNorm and
   ``PDTPU_FUSED_BN=0``), and a fifth or less of the distance of the
   same sharded step with each rank's own statistics (the
   counterfactual); three steps' losses printed;
3. times GPT-2 medium (24 x 1024, vocab 50304, dropout 0, O1 bf16,
   recompute, AdamW 1e-4) data parallel over every card, B 4 per card x
   S 1024, captured, at ZeRO stage 2 and at stage 3: device ms per step
   by CUDA events over ``--steps`` steps, tokens/s over all cards, peak
   bytes allocated and the bytes the card holds between steps (reserved,
   after ``empty_cache``; the captured graph's pool included); rank 0
   first times ``TrainStep(remat=True)`` on its 4 rows alone, the
   one-card baseline;
4. tears its process groups down under a watchdog: each rank prints how
   long ``destroy_process_group`` took, or its threads' stacks and exit
   code 3 when it has not returned in ``TEARDOWN_S`` seconds.

Rank 0 prints the cards' name and power limit and one JSON line; every
rank exits non-zero when a check fails.  Needs 4 cards; without a card
it runs parts 1, 2 and 4 on the CPU over gloo (a rehearsal).
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repo

TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=32,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
TEARDOWN_S = 60.0


def batches(torch, dev, n=3, b=8, s=16, vocab=64):
    rng = np.random.RandomState(0)
    return [tuple(torch.from_numpy(rng.randint(0, vocab, (b, s))).to(dev)
                  for _ in range(2)) for _ in range(n)]


def tiny(torch, dev, seed):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import (GPTConfig, GPTForPretraining,
                                         GPTPretrainingCriterion)
    pt.seed(seed)
    model = GPTForPretraining(GPTConfig(**TINY), device=dev, seed=seed)
    crit = GPTPretrainingCriterion()
    opt = pt.optimizer.Adam(learning_rate=1e-2, parameters=model.parameters())
    return model, (lambda lg, y: crit(lg, y)), opt


def check(tag, got, want, tol):
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    if not rel <= tol:
        raise SystemExit(f"parallel_probe: {tag}: losses {got} against "
                         f"{want}: {rel:.2e} > {tol}")
    return rel


def tiny_cases(torch, dev, seed):
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.parallel.pipeline import gpt_pipeline_step
    data = batches(torch, dev)
    model, loss, opt = tiny(torch, dev, seed)
    step = TrainStep(model, loss, opt)
    want = [float(step(*b)) for b in data]
    out = {}
    cases = (("dp4", {"dp": 4}, {}),
             ("dp2_tp2", {"dp": 2, "tp": 2}, {"tensor_parallel": True}),
             ("zero2", {"dp": 4}, {"sharding": True, "_stage": 2}),
             ("fsdp", {"dp": 4}, {"sharding": True, "_stage": 3}))
    for tag, axes, kw in cases:
        model, loss, opt = tiny(torch, dev, seed)
        st = parallel.DistributedStrategy(
            **{k: v for k, v in kw.items() if not k.startswith("_")})
        st.sharding_configs.stage = kw.get("_stage", 2)
        st.hybrid_configs.mp_degree = axes.get("tp", 1)
        step = parallel.ShardedTrainStep(model, loss, opt, strategy=st,
                                         mesh=parallel.create_mesh(axes))
        out[tag] = check(tag, [float(step(*b)) for b in data], want, 1e-5)
    for sched in ("gpipe", "1f1b"):
        model, _, opt = tiny(torch, dev, seed)
        step = gpt_pipeline_step(model, opt,
                                 parallel.create_mesh({"pp": 2, "dp": 2}),
                                 n_micro=2, remat=True, schedule=sched)
        out[sched] = check(sched, [float(step(*b)) for b in data], want,
                           1e-5)
    out["ring"] = ring_case(torch, dev)
    return out


def ring_case(torch, dev):
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.ops.ring_attention import ring_attention
    gen = torch.Generator(device=dev).manual_seed(3)
    b, s, h, d = 2, 256, 4, 64
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev)
               for _ in range(3))
    mesh = parallel.create_mesh({"dp": 2, "sp": 2})
    worst = 0.0
    for causal in (False, True):
        def naive(q, k, v):
            sc = q.transpose(1, 2) @ k.transpose(1, 2).transpose(-1, -2)
            sc = sc / d ** 0.5
            if causal:
                sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool,
                                                device=dev).tril(), -1e30)
            return (torch.softmax(sc, -1) @ v.transpose(1, 2)).transpose(1, 2)
        res = []
        for fn in (lambda *t: ring_attention(*t, mesh, causal=causal),
                   naive):
            ins = [t.clone().requires_grad_() for t in (q, k, v)]
            o = fn(*ins)
            o.sum().backward()
            res.append([o.detach()] + [t.grad for t in ins])
        for i, (got, want) in enumerate(zip(*res)):
            err = float((got - want).abs().max() / want.abs().max())
            if not err <= (2e-4 if i == 0 else 2e-3):
                raise SystemExit(f"parallel_probe: ring attention "
                                 f"(causal={causal}) tensor {i}: {err:.2e}")
            worst = max(worst, err)
    return worst


def _close(tag, got, want):
    """Within 1e-4 of ``want``'s largest |value|, one element in a million
    excepted; returns the largest difference over that scale."""
    got, want = got.detach().double(), want.detach().double()
    scale = float(want.abs().max()) or 1.0
    bad = int(((got - want).abs() > 1e-4 * scale).sum())
    if bad > got.numel() // 1_000_000:
        raise SystemExit(f"parallel_probe: {tag}: {bad} elements past 1e-4 "
                         f"of {scale:.3e}")
    return float((got - want).abs().max()) / scale


def bn_case(torch, dev, card, mesh):
    """The fused BatchNorm's statistics over the ``dp`` group against one
    card on the whole batch (module docstring, part 2)."""
    import torch.distributed as dist

    from paddle_tpu_torch.ops import fused_bn_act as fbn
    shape = (64, 112, 112, 64) if card else (16, 28, 28, 16)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(*shape, generator=gen, device=dev) + 0.5
    gamma = torch.rand(shape[-1], generator=gen, device=dev) + 0.5
    beta = torch.randn(shape[-1], generator=gen, device=dev)
    group = mesh.group("dp")
    rows = slice(mesh.coord("dp") * shape[0] // 4,
                 (mesh.coord("dp") + 1) * shape[0] // 4)
    out = {}
    for form in ("act", "pool"):
        def run(x, grp):
            ins = [t.clone().requires_grad_() for t in (x, gamma, beta)]
            with fbn.stats_group(grp):
                if form == "act":
                    y, mean, var = fbn.bn_act_train(*ins, 1e-5, "relu")
                else:
                    y, mean, var = fbn.bn_act_pool_train(
                        *ins, 1e-5, "relu", ("max", 3, 2, 1))
            ct = torch.ones_like(y) + 0.01 * torch.arange(y.shape[-1],
                                                         device=dev)
            return [y.detach(), mean, var] + list(
                torch.autograd.grad(y, ins, ct))
        n0 = fbn.stats_group.all_reduces
        got = run(x[rows], group)
        reduces = fbn.stats_group.all_reduces - n0
        want = run(x, None)
        for g in got[4:]:                  # dgamma, dbeta: each rank's part
            dist.all_reduce(g, group=group)
        names = ("y", "mean", "var", "dx", "dgamma", "dbeta")
        errs = {n: _close(f"bn {form} {n}", g,
                          w[rows] if n in ("y", "dx") else w)
                for n, g, w in zip(names, got, want)}
        if reduces != 2:
            raise SystemExit(f"parallel_probe: bn {form}: {reduces} "
                             "statistics all-reduces, want 2")
        out[form] = errs
    return out


def resnet_case(torch, dev, seed, card):
    """ResNet through ShardedTrainStep over {"dp": 4} against a one-card
    TrainStep on the global batch (module docstring, part 2)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.jit import TrainStep, layout_policy
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import fused_bn_act as fbn
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import models as tvm
    make_net = tvm.resnet50 if card else tvm.resnet18
    b, hw = (64, 224) if card else (16, 64)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, 3, hw, hw, generator=gen, device=dev)
    y = torch.randint(0, 1000, (b,), generator=gen, device=dev)
    real = fbn.stats_group

    def own(group):            # the counterfactual: each rank's statistics
        return real(None)
    own.all_reduces = 0        # the captured programs' counters read it

    def loss(lg, t):
        return F.cross_entropy(lg, t)
    runs = {}
    for tag in ("one", "one_plain", "sharded", "sharded_own"):
        pt.seed(seed)
        model = make_net(device=dev, seed=seed)
        before = [p.detach().clone() for p in model.parameters()]
        opt = Momentum(learning_rate=0.01, momentum=0.9,
                       parameters=model.parameters())
        os.environ["PDTPU_FUSED_BN"] = "0" if tag == "one_plain" else "1"
        fbn.stats_group = own if tag == "sharded_own" else real
        try:
            with layout_policy("NHWC"):
                step = (TrainStep(model, loss, opt)
                        if tag.startswith("one") else
                        parallel.ShardedTrainStep(
                            model, loss, opt,
                            mesh=parallel.create_mesh({"dp": 4})))
                k5, reduces = fbn.bn_stats.launches, real.all_reduces
                losses = [float(step(x, y))]
                grad = torch.cat([(p.detach() - p0).flatten() for p, p0 in
                                  zip(model.parameters(), before)])
                k5 = fbn.bn_stats.launches - k5
                reduces = real.all_reduces - reduces
                losses += [float(step(x, y)) for _ in range(2)]
        finally:
            fbn.stats_group = real
            os.environ.pop("PDTPU_FUSED_BN")
        runs[tag] = dict(losses=losses, grad=grad.double(), k5=k5,
                         reduces=reduces)
        del model, opt, step, before
        if card:
            torch.cuda.empty_cache()
    g1 = runs["one"]["grad"]
    dist = {t: float((r["grad"] - g1).norm() / g1.norm())
            for t, r in runs.items()}
    out = {"first_loss_rel": check("resnet dp4 first loss",
                                   runs["sharded"]["losses"][:1],
                                   runs["one"]["losses"][:1], 1e-5),
           "grad_rel": dist, "losses": {t: r["losses"]
                                        for t, r in runs.items()},
           "k5_launches": runs["sharded"]["k5"],
           "stats_all_reduces": runs["sharded"]["reduces"]}
    if not (dist["sharded"] <= 2 * dist["one_plain"] and
            dist["sharded"] <= 0.2 * dist["sharded_own"]):
        raise SystemExit(f"parallel_probe: resnet dp4: the first step's "
                         f"gradient against one card: {dist}")
    if not out["stats_all_reduces"] > 0 or (card and not out["k5_launches"]):
        raise SystemExit(f"parallel_probe: resnet dp4: {out}")
    return out


def gpt_medium(torch, dev, seed, rank, world, steps):
    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion,
                                         gpt2_medium_config)
    cfg = gpt2_medium_config(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    crit = GPTPretrainingCriterion()
    rng = np.random.RandomState(seed)
    b, s = 4 * world, 1024
    ids, labels = (torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))
                                    ).to(dev) for _ in range(2))

    def make():
        pt.seed(seed)
        model = GPTForPretraining(cfg, device=dev, seed=seed)
        return model, pt.optimizer.AdamW(learning_rate=1e-4,
                                         parameters=model.parameters())

    def timed(step, batch):
        step.warmup(*batch)
        for _ in range(2):
            step(*batch)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(steps):
            loss = step(*batch)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / steps, float(loss)
    one = None
    if rank == 0:
        model, opt = make()
        step = TrainStep(model, lambda lg, y: crit(lg, y), opt,
                         amp_level="O1", remat=True)
        one = timed(step, (ids[:4], labels[:4]))
        del model, opt, step
        torch.cuda.empty_cache()
    dist.barrier()
    out = {"one_card_ms": None if one is None else one[0],
           "one_card_tokens_per_s": None if one is None
           else 4 * s / one[0] * 1e3}
    for stage in (2, 3):
        model, opt = make()
        st = parallel.DistributedStrategy(sharding=True, recompute=True,
                                          amp=True)
        st.sharding_configs.stage = stage
        step = parallel.ShardedTrainStep(
            model, lambda lg, y: crit(lg, y), opt, strategy=st,
            mesh=parallel.create_mesh({"dp": world}))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms, loss = timed(step, (ids, labels))
        torch.cuda.empty_cache()
        out[f"stage{stage}"] = {
            "ms": ms, "tokens_per_s": b * s / ms * 1e3, "loss": loss,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "held_gib": torch.cuda.memory_reserved() / 2 ** 30}
        del model, opt, step
        torch.cuda.empty_cache()
    check("gpt2 medium stage 3 against stage 2", [out["stage3"]["loss"]],
          [out["stage2"]["loss"]], 1e-3)
    return out


def teardown(rank):
    """``dist.destroy_process_group()`` under a watchdog: its seconds, or
    the threads' stacks and exit code 3 past ``TEARDOWN_S``."""
    import torch.distributed as dist
    done = threading.Event()

    def watch():
        if not done.wait(TEARDOWN_S):
            print(f"parallel_probe: rank {rank}: destroy_process_group has "
                  f"not returned in {TEARDOWN_S:.0f} s", file=sys.stderr,
                  flush=True)
            faulthandler.dump_traceback(all_threads=True)
            os._exit(3)
    threading.Thread(target=watch, daemon=True).start()
    t0 = time.perf_counter()
    dist.destroy_process_group()
    done.set()
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch import distributed as D
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = D.init_parallel_env()
    rank, world = env.rank, env.world_size
    if world != 4:
        raise SystemExit("parallel_probe: needs 4 ranks, one per card")
    card = torch.cuda.is_available()
    dev = torch.device("cuda", env.dev_id) if card else torch.device("cpu")
    if card:
        torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    from paddle_tpu_torch import parallel
    out = {"tiny_rel": tiny_cases(torch, dev, args.seed),
           "bn_dp4": bn_case(torch, dev, card,
                             parallel.create_mesh({"dp": 4})),
           "resnet_dp4": resnet_case(torch, dev, args.seed, card)}
    # without a card (a rehearsal on gloo): no GPT-2 medium timing
    out["gpt2_medium_dp4"] = (gpt_medium(torch, dev, args.seed, rank, world,
                                         args.steps) if card else None)
    out["seconds"] = time.perf_counter() - t0
    dist.barrier()
    if rank == 0:
        cards = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip().replace("\n", "; ") if card else "none (CPU)"
        print(f"cards: {cards}")
        print(json.dumps(out), flush=True)
    took = teardown(rank)
    print(f"parallel_probe: rank {rank}: destroy_process_group returned in "
          f"{took:.3f} s", flush=True)


if __name__ == "__main__":
    main()
