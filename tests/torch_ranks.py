"""Rank side of the port's multi-rank CPU tests (tests/test_torch_parallel.py,
tests/test_torch_distributed.py).

``run_group(world, names, out_dir)`` spawns ``world`` processes, starts a
gloo group among them from a file store in ``out_dir`` (no TCP port: test
files run side by side), runs every named scenario in order on every rank
and writes each rank's results as ``<name>-r<rank>.npz`` (or the error as
``<name>-r<rank>.err``).  The join has a hard limit: past it the group is
killed.  Each rank destroys its group before it exits.  The inputs every
scenario needs (the reference's initial weights, written by the test
before the spawn) are read from ``out_dir``; batches come from numpy
seeds.  Nothing here imports the JAX package.
"""
import json
import multiprocessing as mp
import os
import time
import traceback

import numpy as np

TINY_GPT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=32,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
LR = 1e-2


def gpt_batches(n=3, b=8, s=16, vocab=64):
    rng = np.random.RandomState(0)
    return [(rng.randint(0, vocab, (b, s)).astype("int64"),
             rng.randint(0, vocab, (b, s)).astype("int64"))
            for _ in range(n)]


# -- the group ---------------------------------------------------------------

def _rank_main(rank, world, names, out_dir):
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
        world_size=world, rank=rank)
    try:
        for name in names:
            try:
                res = SCENARIOS[name](rank, world, out_dir)
                np.savez(os.path.join(out_dir, f"{name}-r{rank}.npz"),
                         **{k: np.asarray(v) for k, v in (res or {}).items()})
            except Exception:
                with open(os.path.join(out_dir, f"{name}-r{rank}.err"),
                          "w") as f:
                    f.write(traceback.format_exc())
                raise
            finally:
                from paddle_tpu_torch.parallel import set_mesh
                set_mesh(None)
    finally:
        dist.destroy_process_group()


def run_group(world, names, out_dir, limit=240.0):
    """Run the scenarios on ``world`` spawned gloo ranks; returns after
    every rank exits, or kills them at ``limit`` seconds."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, list(names),
                                                  str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + limit
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    return [p.exitcode for p in procs]


def result(out_dir, name, rank=0):
    """The scenario's results on ``rank``; raises with the rank's error."""
    path = os.path.join(str(out_dir), f"{name}-r{rank}")
    for r in range(16):   # the first rank that failed explains it best
        err = os.path.join(str(out_dir), f"{name}-r{r}.err")
        if os.path.exists(err):
            raise AssertionError(open(err).read())
    if not os.path.exists(path + ".npz"):
        raise AssertionError(f"{name}: rank {rank} wrote no result (the "
                             "group was killed at its time limit?)")
    with np.load(path + ".npz") as f:
        return {k: f[k] for k in f.files}


# -- scenarios -------------------------------------------------------------

def _tiny_gpt(out_dir, layers=2):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import (GPTConfig, GPTForPretraining,
                                         GPTPretrainingCriterion)
    cfg = dict(TINY_GPT, num_hidden_layers=layers)
    m = GPTForPretraining(GPTConfig(**cfg), device="cpu")
    with np.load(os.path.join(out_dir, f"gpt{layers}.npz")) as f:
        pt.load_paddle_state(m, {k: f[k] for k in f.files})
    return m, GPTPretrainingCriterion()


def _sharded_losses(out_dir, axes, n=3, layers=2, **st_kw):
    import torch
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.optimizer import Adam
    model, crit = _tiny_gpt(out_dir, layers)
    opt = Adam(learning_rate=LR, parameters=model.parameters())
    st = parallel.DistributedStrategy(**{k: v for k, v in st_kw.items()
                                         if not k.startswith("_")})
    if st.sharding:
        st.sharding_configs.stage = st_kw.get("_stage", 2)
    if st.tensor_parallel:
        st.hybrid_configs.mp_degree = axes.get("tp", 1)
    if st.gradient_merge:
        st.gradient_merge_configs.k_steps = st_kw["_k"]
    mesh = parallel.create_mesh(axes)
    step = parallel.ShardedTrainStep(model, lambda lg, y: crit(lg, y), opt,
                                     strategy=st, mesh=mesh)
    losses = [float(step(torch.from_numpy(i), torch.from_numpy(y)))
              for i, y in gpt_batches(n)]
    state = model.state_dict()
    out = {"losses": np.asarray(losses)}
    for k, lay in step._layouts.items():
        out["shape:" + k] = np.asarray(state[k].shape)
        out["whole:" + k] = lay.gather(state[k].detach()).numpy()
    for k, lay in step._moments.items():
        slot = next(iter(step._opt_state[k].values()))
        out["moment:" + k] = np.asarray(slot.shape)
    for k, v in state.items():
        if k not in step._layouts:
            out["whole:" + k] = v.numpy()
    return out


def sc_dp4(rank, world, out_dir):
    return _sharded_losses(out_dir, {"dp": 4})


def sc_tp(rank, world, out_dir):
    return _sharded_losses(out_dir, {"dp": 2, "tp": 2}, tensor_parallel=True)


def sc_zero2(rank, world, out_dir):
    return _sharded_losses(out_dir, {"dp": 4}, sharding=True, _stage=2)


def sc_fsdp(rank, world, out_dir):
    return _sharded_losses(out_dir, {"dp": 4}, sharding=True, _stage=3)


def sc_merge(rank, world, out_dir):
    return _sharded_losses(out_dir, {"dp": 2, "tp": 2}, n=2,
                           gradient_merge=True, _k=2)


def sc_recompute(rank, world, out_dir):
    return _sharded_losses(out_dir, {"dp": 4}, n=2, recompute=True)


def sc_collectives(rank, world, out_dir):
    import torch
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch import parallel
    parallel.set_mesh(parallel.create_mesh({"dp": world}))
    x = torch.arange(4, dtype=torch.float32) + 10 * rank
    out = {}
    t = x.clone()
    C.all_reduce(t)
    out["sum"] = t
    for op in ("max", "min", "avg"):
        t = x.clone()
        C.all_reduce(t, op=op)
        out[op] = t
    signs = torch.tensor([[-2.0], [3.0], [-1.0], [2.0]])[rank]
    t = signs.clone()
    C.all_reduce(t, op=C.ReduceOp.PROD)
    out["prod"] = t
    t = torch.tensor([[-2.0], [3.0], [0.0], [2.0]])[rank].clone()
    C.all_reduce(t, op=C.ReduceOp.PROD)
    out["prod_zero"] = t
    parts = []
    out["gather"] = C.all_gather(parts, x)
    out["n_parts"] = len(parts)
    t = x.clone()
    C.broadcast(t, src=3)
    out["bcast"] = t
    out["shift"] = C.ppermute(x, shift=1)
    out["rs"] = C.reduce_scatter(None, torch.arange(8.0) + rank)
    out["p2p"] = C.p2p(x, pairs=[(1, 3)])
    out["a2a"] = torch.stack(C.alltoall([x + i for i in range(world)]))
    t = torch.zeros(4)
    C.scatter(t, [torch.full((4,), float(i)) for i in range(world)], src=2)
    out["scatter"] = t
    if rank == 0:
        C.send(x + 100, dst=1)
    elif rank == 1:
        t = torch.zeros(4)
        C.recv(t, src=0)
        out["recv"] = t
    C.barrier()
    out["spmd"] = [C.get_rank_in_spmd("dp"), C.get_world_size_in_spmd("dp")]
    return out


def _pipeline(out_dir, axes, schedule, n_micro, layers, n=3, frozen=False):
    import torch
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel.pipeline import gpt_pipeline_step
    model, _ = _tiny_gpt(out_dir, layers)
    if frozen:
        model.gpt.blocks[0].qkv.weight.requires_grad_(False)
    opt = Adam(learning_rate=LR, parameters=model.parameters())
    mesh = parallel.create_mesh(axes)
    step = gpt_pipeline_step(model, opt, mesh, n_micro=n_micro, remat=True,
                             schedule=schedule)
    batches = gpt_batches(n, b=8, s=16)
    ids = torch.from_numpy(batches[0][0])
    mem = step.memory_stats(ids, torch.from_numpy(batches[0][1]))
    losses = [float(step(torch.from_numpy(i), torch.from_numpy(y)))
              for i, y in batches]
    step.sync_to_model()
    model.eval()
    with torch.no_grad():
        logits = model(ids)
    return {"losses": np.asarray(losses), "temp_bytes": mem["temp_bytes"],
            "finite": bool(torch.isfinite(logits).all()),
            "qkv0": model.gpt.blocks[0].qkv.weight.detach().numpy(),
            "qkv1": model.gpt.blocks[1].qkv.weight.detach().numpy()}


def sc_gpipe(rank, world, out_dir):
    return _pipeline(out_dir, {"pp": 2, "dp": 2}, "gpipe", 2, 2)


def sc_1f1b(rank, world, out_dir):
    return _pipeline(out_dir, {"pp": 2, "dp": 2}, "1f1b", 2, 2)


def sc_pipe_mem(rank, world, out_dir):
    out = {}
    for sched in ("gpipe", "1f1b"):
        r = _pipeline(out_dir, {"pp": 2, "dp": 2}, sched, 4, 4, n=1)
        out[sched] = r["temp_bytes"]
    return out


def sc_pipe_frozen(rank, world, out_dir):
    return _pipeline(out_dir, {"pp": 2, "dp": 2}, "gpipe", 2, 2, n=1,
                     frozen=True)


def sc_ring(rank, world, out_dir):
    import torch
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.ops.ring_attention import ring_attention
    rng = np.random.RandomState(3)
    b, s, h, d = 2, 32, 4, 8
    q, k, v = (torch.from_numpy(rng.randn(b, s, h, d).astype("float32"))
               for _ in range(3))
    mesh = parallel.create_mesh({"dp": 2, "sp": 2})
    out = {}
    for causal in (False, True):
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        o = ring_attention(qs, ks, vs, mesh, causal=causal)
        o.sum().backward()
        tag = "causal" if causal else "full"
        out[tag] = o.detach()
        for n_, t in (("dq", qs), ("dk", ks), ("dv", vs)):
            out[f"{tag}_{n_}"] = t.grad
    return out


# -- world of two: tests/test_torch_distributed.py ---------------------------

def mlp_data(n=64, seed=0, out=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8).astype("float32")
    y = ((x.sum(-1, keepdims=True) > 0).astype("float32") if out == 1
         else rng.randn(n, out).astype("float32"))
    return x, y


def _mlp(out_dir, name, out=1):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    m = nn.Sequential(nn.Linear(8, 16, device="cpu"), nn.ReLU(),
                      nn.Linear(16, out, device="cpu"))
    with np.load(os.path.join(out_dir, name)) as f:
        pt.load_paddle_state(m, {k: f[k] for k in f.files})
    return m


def _mse(pred, label):
    return ((pred - label) ** 2).mean()


def _state(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def sc_env(rank, world, out_dir):
    from paddle_tpu_torch import distributed as D
    env = D.init_parallel_env()   # started already: no second group
    return {"rank": env.rank, "world": env.world_size, "nranks": env.nranks,
            "get": [D.get_rank(), D.get_world_size()],
            "init": D.is_initialized(), "dev": env.dev_id}


def sc_ddp(rank, world, out_dir):
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.optimizer import SGD
    m = _mlp(out_dir, "ddp.npz", out=4)
    ddp = D.DataParallel(m)
    opt = SGD(0.1, parameters=ddp.parameters())
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(3):
        x = torch.from_numpy(rng.randn(16, 8).astype("float32"))
        y = torch.from_numpy(rng.randn(16, 4).astype("float32"))
        out = ddp(x)
        rows = y.shape[0] // world
        loss = ddp.scale_loss(_mse(out, y[rank * rows:(rank + 1) * rows]))
        loss.backward()
        ddp.apply_collective_grads()
        opt.step()
        opt.clear_grad()
        g = loss.detach().clone()
        dist.all_reduce(g)
        losses.append(float(g) / world)
    return {"losses": losses, "out_rows": out.shape[0], **{
        "p:" + k: v for k, v in _state(m).items()}}


def sc_syncbn(rank, world, out_dir):
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch import nn
    with np.load(os.path.join(out_dir, "bn.npz")) as f:
        d = {k: f[k] for k in f.files}
    rows = d["x"].shape[0] // world
    sl = slice(rank * rows, (rank + 1) * rows)
    out = {}
    for form in ("plain", "fused"):
        bn = nn.SyncBatchNorm(3, device="cpu")
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(d["gamma"]))
            bn.bias.copy_(torch.from_numpy(d["beta"]))
        x = torch.from_numpy(d["x"][sl]).requires_grad_()
        y = bn(x) if form == "plain" else bn.forward_fused(
            x, activation="relu")
        (y * torch.from_numpy(d["w"][sl])).sum().backward()
        gw, gb = bn.weight.grad.clone(), bn.bias.grad.clone()
        dist.all_reduce(gw)
        dist.all_reduce(gb)
        out.update({f"{form}_y": y.detach(), f"{form}_dx": x.grad,
                    f"{form}_dgamma": gw, f"{form}_dbeta": gb,
                    f"{form}_mean": bn._mean.clone()})
    return out


def sc_resnet(rank, world, out_dir):
    import torch
    from paddle_tpu_torch import jit, parallel
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import fused_bn_act as fbn
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import models as tvm
    import paddle_tpu_torch as pt
    with np.load(os.path.join(out_dir, "resnet.npz")) as f:
        state = {k: f[k] for k in f.files}
    with np.load(os.path.join(out_dir, "resnet_batch.npz")) as f:
        x, y = torch.from_numpy(f["x"]), torch.from_numpy(f["y"])
    out = {}
    for tag in ("sharded", "single"):
        m = pt.load_paddle_state(tvm.resnet18(num_classes=6, device="cpu"),
                                 state)
        opt = Momentum(learning_rate=0.01, momentum=0.9,
                       parameters=m.parameters())
        with jit.layout_policy("NHWC"):
            if tag == "sharded":
                step = parallel.ShardedTrainStep(
                    m, lambda lg, t: F.cross_entropy(lg, t), opt,
                    mesh=parallel.create_mesh({"dp": world}))
            else:
                step = jit.TrainStep(m, lambda lg, t: F.cross_entropy(lg, t),
                                     opt)
            losses, reduces = [], []
            for _ in range(2):
                n0 = fbn.stats_group.all_reduces
                losses.append(float(step(x, y)))
                reduces.append(fbn.stats_group.all_reduces - n0)
        out[tag + "_losses"] = losses
        out[tag + "_reduces"] = reduces
        for k, v in _state(m).items():
            out[f"{tag}:{k}"] = v
    return out


def _lsgd(out_dir, k, n):
    import torch
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.optimizer import SGD
    m = _mlp(out_dir, "avg.npz")
    opt = SGD(0.1, parameters=m.parameters())
    step = parallel.LocalSGDTrainStep(m, _mse, opt, k_steps=k,
                                      mesh=parallel.create_mesh({"dp": 2}))
    x, y = (torch.from_numpy(t) for t in mlp_data(64))
    losses = [float(step(x, y)) for _ in range(n)]
    return step, m, losses


def sc_localsgd(rank, world, out_dir):
    _, m1, l1 = _lsgd(out_dir, 1, 4)
    step3, m3, l3 = _lsgd(out_dir, 3, 9)
    out = {"k1_losses": l1, "k3_losses": l3}
    out.update({"k1:" + k: v for k, v in _state(m1).items()})
    out.update({"k3:" + k: v for k, v in _state(m3).items()})
    return out


def sc_localsgd_ckpt(rank, world, out_dir):
    import torch
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.optimizer import SGD
    step, m, _ = _lsgd(out_dir, 2, 3)
    d = os.path.join(out_dir, "lsgd")
    step.save_checkpoint(d, step=3)
    before = {k: v.clone() for k, v in step._replica.items()}
    m2 = _mlp(out_dir, "avg.npz")
    step2 = parallel.LocalSGDTrainStep(
        m2, _mse, SGD(0.1, parameters=m2.parameters()), k_steps=2,
        mesh=parallel.create_mesh({"dp": 2}))
    meta = step2.restore_checkpoint(d)
    same = all(torch.equal(step2._replica[k], v) for k, v in before.items())
    x, y = (torch.from_numpy(t) for t in mlp_data(64))
    return {"step": meta["step"], "same": same,
            "next": [float(step(x, y)), float(step2(x, y))]}


def sc_fp16(rank, world, out_dir):
    import torch
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.optimizer import SGD
    out = {}
    for flag in (True, False):
        m = _mlp(out_dir, "avg.npz")
        st = parallel.DistributedStrategy(fp16_allreduce=flag)
        step = parallel.ShardedTrainStep(
            m, _mse, SGD(0.1, parameters=m.parameters()), strategy=st,
            mesh=parallel.create_mesh({"dp": 2}))
        x, y = (torch.from_numpy(t) for t in mlp_data(64))
        out[str(flag)] = [float(step(x, y)) for _ in range(5)]
    return out


def _fsdp_gpt(out_dir):
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.optimizer import Adam
    model, crit = _tiny_gpt(out_dir)
    st = parallel.DistributedStrategy(sharding=True)
    st.sharding_configs.stage = 3
    step = parallel.ShardedTrainStep(
        model, lambda lg, y: crit(lg, y),
        Adam(learning_rate=LR, parameters=model.parameters()),
        strategy=st, mesh=parallel.create_mesh({"dp": 2}))
    return step, model


def sc_ckpt_port(rank, world, out_dir):
    """A stage-3 step on two ranks writes its blocks; a fresh step
    restores them; the whole arrays come back without a mesh."""
    import torch
    from paddle_tpu_torch.distributed import checkpoint as dck
    step, model = _fsdp_gpt(out_dir)
    ids, labels = gpt_batches(1)[0]
    step(torch.from_numpy(ids), torch.from_numpy(labels))
    d = os.path.join(out_dir, "port_ckpt")
    step.save_checkpoint(d)
    state = model.state_dict()
    out = {}
    for k, lay in step._layouts.items():
        out["whole:" + k] = lay.gather(state[k].detach()).numpy()
        out["m1:" + k] = lay.gather(step._opt_state[k]["moment1"]).numpy()
    step2, model2 = _fsdp_gpt(out_dir)
    meta = step2.restore_checkpoint(d)
    s2 = model2.state_dict()
    out["restored_equal"] = all(
        torch.equal(s2[k], state[k]) for k in step._layouts) and all(
        torch.equal(step2._opt_state[k]["moment1"],
                    step._opt_state[k]["moment1"]) for k in step._layouts)
    out["step"] = meta["step"]
    whole, _, _ = dck.restore_sharded(d)
    out["whole_equal"] = all(
        np.array_equal(whole["params"][k].numpy(), out["whole:" + k])
        for k in step._layouts)
    return out


def sc_ckpt_ref(rank, world, out_dir):
    """The reference's checkpoint from a 4-device mesh, restored as this
    rank's blocks on {"dp": 2}."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.distributed import checkpoint as dck
    mesh = parallel.create_mesh({"dp": 2})
    tree, step, _ = dck.restore_sharded(
        os.path.join(out_dir, "ref_ckpt"), mesh=mesh,
        shardings={"params": {"w": parallel.NamedSharding(
            mesh, parallel.P("dp", None))}})
    return {"w": tree["params"]["w"], "b": tree["params"]["b"],
            "step": step}


def sc_fleet(rank, world, out_dir):
    import torch
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import Adam
    st = parallel.DistributedStrategy(tensor_parallel=True)
    st.hybrid_configs.mp_degree = 2
    fleet.init(is_collective=True, strategy=st)
    mesh = parallel.get_mesh()
    model, crit = _tiny_gpt(out_dir)
    opt = fleet.distributed_optimizer(Adam(learning_rate=LR,
                                           parameters=model.parameters()))
    step = fleet.distributed_train_step(model, lambda lg, y: crit(lg, y),
                                        opt)
    ids, labels = gpt_batches(1)[0]
    loss = float(step(torch.from_numpy(ids), torch.from_numpy(labels)))
    util = fleet.fleet.util
    return {"tp": mesh.shape["tp"], "num": fleet.worker_num(),
            "first": fleet.is_first_worker(), "loss": loss,
            "kind": type(step).__name__,
            "sum": util.all_reduce([rank + 1.0]),
            "shard": util.get_file_shard(["a", "b", "c"])}


def sc_stage3_blocks(rank, world, out_dir):
    """Stage 2 and stage 3 on {"dp": 4} over a 4-layer GPT, with and
    without recompute: losses, the whole parameters after the steps, and
    stage 3's gathered bytes alive at most against the model's."""
    import torch
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import train_step as ts
    out = {}
    for remat in (False, True):
        for stage in (2, 3):
            model, crit = _tiny_gpt(out_dir, 4)
            st = parallel.DistributedStrategy(sharding=True, recompute=remat)
            st.sharding_configs.stage = stage
            step = parallel.ShardedTrainStep(
                model, lambda lg, y: crit(lg, y),
                Adam(learning_rate=LR, parameters=model.parameters()),
                strategy=st, mesh=parallel.create_mesh({"dp": world}))
            ts.reset_gather_stats()
            tag = f"s{stage}{'r' if remat else ''}"
            out[tag + "_losses"] = [
                float(step(torch.from_numpy(i), torch.from_numpy(y)))
                for i, y in gpt_batches(2)]
            out[tag + "_peak"] = ts.gather_stats["peak"]
            state = model.state_dict()
            for k, v in state.items():
                lay = step._layouts.get(k)
                out[f"{tag}:{k}"] = (lay.gather(v) if lay else v).numpy()
            if stage == 3:
                units = step._units
                size = {k: int(np.prod(lay.shape)) * 4
                        for k, lay in step._layouts.items()}
                out["whole_bytes"] = sum(size.values())
                out["root_bytes"] = sum(size[k] for k, _, _ in units.root)
                out["block_bytes"] = max(
                    sum(size[k] for k, _, _ in keys)
                    for mod, keys in units.units[:-1])
    return out


# -- tensor-parallel serving: tests/test_torch_tp_serving.py -----------------

TP_GPT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=8, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0, max_position_embeddings=64)
TP_CASES = (dict(max_new_tokens=8),
            dict(max_new_tokens=8, decode_strategy="sampling",
                 temperature=0.9, top_k=5, seed=11),
            dict(max_new_tokens=6, decode_strategy="sampling", top_p=0.85,
                 seed=4))


def tp_prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(0, 64, (int(rng.randint(3, 8)),)) for _ in TP_CASES]


def _tp_model(out_dir, cfg=None, name="tp_gpt.npz"):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    m = GPTForPretraining(GPTConfig(**(cfg or TP_GPT)), device="cpu").eval()
    with np.load(os.path.join(out_dir, name)) as f:
        pt.load_paddle_state(m, {k: f[k] for k in f.files})
    return m


def _engines(m, world, **kw):
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.serving import ServingEngine
    base = dict(max_slots=2, max_len=32, prefill_buckets=(8,),
                decode_chunk=4, device="cpu")
    base.update(kw)
    tp = ServingEngine(m, mesh=parallel.create_mesh({"tp": world}), **base)
    return tp, ServingEngine(m, **base)


def _serve(eng, rank, prompts, cases, **drain):
    """Every rank drives; the leader submits.  Tokens on the leader, []
    elsewhere."""
    out = []
    for p, kw in zip(prompts, cases):
        r = eng.submit(p, **kw) if rank == 0 else None
        eng.run_until_drained(**drain)
        out.append(r.tokens() if r is not None else [])
    return out


def _single(eng, prompts, cases):
    out = []
    for p, kw in zip(prompts, cases):
        r = eng.submit(p, **kw)
        eng.run_until_drained()
        out.append(r.tokens())
    return out


def sc_tp_serve(rank, world, out_dir):
    """The tp engine against the single-device one: layouts, greedy and
    sampled streams, logits on the same prompt, preempt/restore, the
    compile bound, and paged KV."""
    import torch
    m = _tp_model(out_dir)
    tp, sd = _engines(m, world)
    tp.warmup()
    out = {"mesh": [tp.metrics()["mesh"]["devices"],
                    tp.metrics()["mesh"]["tp"]]}
    st = tp.model.state_dict()
    for k in ("gpt.blocks.0.qkv.weight", "gpt.blocks.0.qkv.bias",
              "gpt.blocks.0.proj.weight", "gpt.blocks.0.ffn_in.weight",
              "gpt.blocks.0.ffn_out.weight", "gpt.word_embeddings.weight",
              "gpt.position_embeddings.weight", "gpt.ln_f.weight",
              "gpt.blocks.0.proj.bias"):
        out["spec:" + k] = repr(tuple(tp._tp_specs[k]))
        out["shape:" + k] = list(st[k].shape)
    out["qkv_block"] = st["gpt.blocks.0.qkv.weight"].numpy()
    out["pool"] = list(tp._pools[0][0].shape)
    prompts = tp_prompts()
    out["tp"] = json.dumps(_serve(tp, rank, prompts, TP_CASES, timeout=120))
    out["sd"] = json.dumps(_single(sd, prompts, TP_CASES))
    cc = tp.compile_counts()
    out["compiles"] = [cc["total"], cc["bound"]]
    # logits of one prompt through the rank-local forward and the whole
    ids = torch.as_tensor(prompts[0][None].astype("int64"))
    with torch.inference_mode():
        got, _ = tp.model.forward_fixed(
            ids, tp.model.gen_fixed_cache(1, 8), 0)
        want, _ = sd.model.forward_fixed(
            ids, sd.model.gen_fixed_cache(1, 8), 0)
    out["logit_err"] = float((got - want).abs().max())
    # preempt / restore keeps the pool this rank's heads, nothing captured
    before = tp.compile_counts()["total"]
    r = tp.submit([9, 8, 7], max_new_tokens=10) if rank == 0 else None
    tp.step()
    paused = tp.preempt_slot(next(iter(tp._slots)))
    out["restored"] = bool(tp.restore_run(paused))
    out["pool_after"] = list(tp._pools[0][0].shape)
    tp.run_until_drained(timeout=120)
    out["restore_tokens"] = r.tokens() if r is not None else []
    s = sd.submit([9, 8, 7], max_new_tokens=10)
    sd.run_until_drained()
    out["restore_want"] = s.tokens()
    out["restore_compiles"] = tp.compile_counts()["total"] - before
    tp.close()
    # paged KV + tp
    tpp, sdp = _engines(m, world, max_slots=4, kv="paged", block_size=8)
    tpp.warmup()
    rng = np.random.RandomState(9)
    pp = [rng.randint(0, 64, (n,)) for n in (4, 6, 7)]
    if rank == 0:
        rs = [tpp.submit(p, max_new_tokens=10) for p in pp]
    tpp.run_until_drained(timeout=120)
    out["paged"] = [r.tokens() for r in rs] if rank == 0 else []
    ss = [sdp.submit(p, max_new_tokens=10) for p in pp]
    sdp.run_until_drained()
    out["paged_want"] = [r.tokens() for r in ss]
    out["paged_pool"] = list(tpp._pools[0][0].shape)
    out["paged_used"] = tpp.kv_pool.used_blocks()
    tpp.close()
    return out


def sc_tp_more(rank, world, out_dir):
    """int8 layout and streams, a speculative engine (draft sharded too),
    swap_weights, requests submitted while the loops run, and the
    refusals of a head count tp does not divide."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.core.errors import InvalidArgumentError
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.quantization import quantize_for_serving
    from paddle_tpu_torch.serving import ServingEngine
    out = {}
    prompts = tp_prompts()
    # int8 weight-only: w_int8 / w_scale stay whole, biases and the
    # embeddings follow the reference's rules
    q = quantize_for_serving(_tp_model(out_dir))
    tp, sd = _engines(q, world)
    st = tp.model.state_dict()
    for k in ("gpt.blocks.0.qkv.w_int8", "gpt.blocks.0.qkv.w_scale",
              "gpt.blocks.0.qkv.bias", "gpt.blocks.0.ffn_in.bias",
              "gpt.word_embeddings.weight"):
        out["int8_spec:" + k] = repr(tuple(tp._tp_specs[k]))
        out["int8_shape:" + k] = list(st[k].shape)
    out["int8_pool"] = list(tp._pools[0][0].shape)
    out["int8"] = json.dumps(_serve(tp, rank, prompts, TP_CASES, timeout=120))
    out["int8_want"] = json.dumps(_single(sd, prompts, TP_CASES))
    tp.close()
    # speculative: the draft (4 heads) sharded as the target
    m = _tp_model(out_dir)
    dcfg = dict(TP_GPT, num_hidden_layers=1, num_attention_heads=4)
    draft = _tp_model(out_dir, dcfg, "tp_draft.npz")
    tp, sd = _engines(m, world, draft_model=draft, spec_tokens=2)
    out["draft_pool"] = list(tp._draft_store[0][0].shape)
    out["spec"] = json.dumps(_serve(tp, rank, prompts, TP_CASES, timeout=120))
    out["spec_want"] = json.dumps(_single(sd, prompts, TP_CASES))
    # swap_weights: whole tensors, cut to the served layout
    other = _tp_model(out_dir, name="tp_other.npz")
    new = {k: v.detach() for k, v in other.state_dict().items()}
    tp.swap_weights(new)
    sd.swap_weights(new)
    out["swap"] = json.dumps(_serve(tp, rank, prompts[:1], TP_CASES[:1],
                                    timeout=120))
    out["swap_want"] = json.dumps(_single(sd, prompts[:1], TP_CASES[:1]))
    tp.close()
    # requests submitted from another thread while every rank's loop runs
    tp, sd = _engines(m, world, max_slots=4)
    tp.start()
    if rank == 0:
        rs = []
        for i, (p, kw) in enumerate(zip(prompts * 2, TP_CASES * 2)):
            rs.append(tp.submit(p, **kw))
            time.sleep(0.01 * (i % 3))
        out["live"] = json.dumps([r.tokens(timeout=120) for r in rs])
    else:
        out["live"] = "[]"
    tp.close()
    out["live_want"] = json.dumps(_single(sd, prompts * 2, TP_CASES * 2))
    # refusals: 2 heads over tp=4, for the target and for the draft
    if world == 4:
        small = GPTForPretraining(GPTConfig(
            vocab_size=64, hidden_size=16, num_hidden_layers=1,
            num_attention_heads=2, max_position_embeddings=64),
            device="cpu").eval()
        mesh = parallel.create_mesh({"tp": world})
        msgs = []
        for kw in (dict(model=small), dict(model=m, draft_model=small,
                                           spec_tokens=2)):
            try:
                ServingEngine(max_slots=2, max_len=32, prefill_buckets=(8,),
                              mesh=mesh, device="cpu", **kw)
                msgs.append("")
            except InvalidArgumentError as e:
                msgs.append(str(e))
        out["refusals"] = msgs
    return out


# -- embedding/: tests/test_torch_embedding.py ------------------------------

def dlrm_batch(i, b=16, high=64, dense_dim=4, feats=4):
    rng = np.random.RandomState(1000 + i)
    return (rng.randn(b, dense_dim).astype("float32"),
            rng.randint(0, high, (b, feats)).astype("int64"),
            rng.randint(0, 2, (b, 1)).astype("float32"))


def sc_emb_sharded(rank, world, out_dir):
    """DLRM with its table's rows over tp=world against the sparse oracle
    (the reference's initial weights in both), TrainStep on every rank;
    the eager lookup's row-sparse update; the refusal of a vocabulary
    the axis does not divide."""
    import torch
    import torch.distributed as dist
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.embedding import ShardedEmbedding
    from paddle_tpu_torch.models import DLRM, DLRMCriterion, dlrm_tiny_config
    from paddle_tpu_torch.optimizer import Adam
    cfg = dlrm_tiny_config()
    with np.load(os.path.join(out_dir, "dlrm.npz")) as f:
        init = {k: f[k] for k in f.files}
    mesh = parallel.create_mesh({"tp": world})
    out = {}
    for mode in ("sparse", "sharded"):
        m = DLRM(cfg, embedding=mode, mesh=mesh, device="cpu")
        state = dict(init)
        if mode == "sharded":
            n = cfg.total_rows // world
            state["table.weight"] = init["table.weight"][rank * n:
                                                         (rank + 1) * n]
        pt.load_paddle_state(m, state)
        opt = Adam(0.01, parameters=m.parameters())
        step = pt.jit.TrainStep(m, DLRMCriterion(), opt)
        out[mode + "_losses"] = [
            float(step(*map(torch.from_numpy, dlrm_batch(i))))
            for i in range(2)]
        w = m.state_dict()["table.weight"]
        m1 = step._opt_state["table.weight"]["moment1"]
        if mode == "sharded":
            out["block_shape"] = list(w.shape)
            parts = [torch.empty_like(w) for _ in range(world)]
            dist.all_gather(parts, w.contiguous())
            w = torch.cat(parts)
            parts = [torch.empty_like(m1) for _ in range(world)]
            dist.all_gather(parts, m1.contiguous())
            m1 = torch.cat(parts)
        out[mode + "_table"] = w.numpy()
        out[mode + "_m1"] = m1.numpy()
        out[mode + "_top"] = m.state_dict()["top.0.weight"].numpy()
    # eager: a row-sparse COO gradient of the rank's rows, Adam moves only
    # the looked-up rows
    emb = ShardedEmbedding(64, 8, mesh=mesh, device="cpu",
                           generator=torch.Generator().manual_seed(1))
    opt = Adam(0.1, parameters=[emb.weight])
    ids = torch.tensor([3, 3, 9, 20, 63])
    o = emb(ids)
    (o * o).sum().backward()
    out["eager_sparse"] = bool(emb.weight.grad.is_sparse)
    w0 = emb.weight.detach().clone()
    opt.step()
    out["eager_moved"] = (emb.weight.detach() != w0).any(dim=1).numpy()
    out["eager_out"] = o.detach().numpy()
    whole = [torch.empty_like(w0) for _ in range(world)]
    dist.all_gather(whole, w0.contiguous())
    out["eager_w0"] = torch.cat(whole).numpy()
    try:
        ShardedEmbedding(63, 8, mesh=mesh, device="cpu")
        out["undivisible"] = ""
    except Exception as e:   # noqa: BLE001 — the message is the result
        out["undivisible"] = str(e)
    return out


def spawn_worker(expect):
    """``spawn``'s worker: the launcher's variables are set."""
    assert os.environ["PADDLE_TRAINERS_NUM"] == str(expect)
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    assert 0 <= rank < expect
    assert os.environ["PADDLE_CURRENT_ENDPOINT"].endswith(
        str(int(os.environ["PADDLE_COORDINATOR"].split(":")[1]) + rank))


def spawn_failing_worker():
    if os.environ["PADDLE_TRAINER_ID"] == "1":
        raise SystemExit(3)


MOE = dict(d=16, f=32, experts=4, vocab=64)


def moe_batches(n=3):
    rng = np.random.RandomState(0)
    return [(rng.randint(0, MOE["vocab"], (8, 8)).astype("int64"),
             rng.randint(0, MOE["vocab"], (8, 8)).astype("int64"))
            for _ in range(n)]


def moe_model(nn):
    """Embedding -> h + MoELayer(h) -> Linear head, in ``nn`` (either
    package's): the reference's tests/test_moe.py model."""
    class MoEModel(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(MOE["vocab"], MOE["d"])
            self.moe = nn.MoELayer(MOE["d"], MOE["f"], MOE["experts"],
                                   top_k=2, capacity_factor=2.0)
            self.head = nn.Linear(MOE["d"], MOE["vocab"])

        def forward(self, ids):
            h = self.emb(ids)
            return self.head(h + self.moe(h))
    return MoEModel()


def sc_moe_ep(rank, world, out_dir):
    """The MoE model through ShardedTrainStep with expert_parallel over an
    ``ep`` axis of 4: each rank holds one expert's block of the experts_*
    weights between steps."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn, parallel
    from paddle_tpu_torch.optimizer import Adam
    model = moe_model(nn)
    with np.load(os.path.join(out_dir, "moe.npz")) as f:
        pt.load_paddle_state(model, {k: f[k] for k in f.files})
    crit = nn.CrossEntropyLoss()

    def loss(logits, labels):
        return (crit(logits.reshape(-1, MOE["vocab"]), labels.reshape(-1))
                + 0.01 * model.moe.aux_loss)
    st = parallel.DistributedStrategy(expert_parallel=True)
    st.hybrid_configs.ep_degree = world
    step = parallel.ShardedTrainStep(
        model, loss, Adam(learning_rate=LR, parameters=model.parameters()),
        strategy=st, mesh=parallel.create_mesh({"ep": world}))
    losses = [float(step(torch.from_numpy(i), torch.from_numpy(y)))
              for i, y in moe_batches()]
    state = model.state_dict()
    out = {"losses": np.asarray(losses)}
    for k, v in state.items():
        lay = step._layouts.get(k)
        out["shape:" + k] = np.asarray(v.shape)
        out["whole:" + k] = (lay.gather(v.detach()) if lay else v).numpy()
    return out


SCENARIOS = {
    "dp4": sc_dp4, "tp": sc_tp, "zero2": sc_zero2, "fsdp": sc_fsdp,
    "merge": sc_merge, "recompute": sc_recompute,
    "collectives": sc_collectives, "gpipe": sc_gpipe, "1f1b": sc_1f1b,
    "pipe_mem": sc_pipe_mem, "pipe_frozen": sc_pipe_frozen, "ring": sc_ring,
    "env": sc_env, "ddp": sc_ddp, "syncbn": sc_syncbn, "resnet": sc_resnet,
    "localsgd": sc_localsgd, "localsgd_ckpt": sc_localsgd_ckpt,
    "fp16": sc_fp16, "ckpt_port": sc_ckpt_port, "ckpt_ref": sc_ckpt_ref,
    "fleet": sc_fleet, "stage3_blocks": sc_stage3_blocks,
    "tp_serve": sc_tp_serve, "tp_more": sc_tp_more,
    "emb_sharded": sc_emb_sharded, "moe_ep": sc_moe_ep,
}
