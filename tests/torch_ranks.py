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


SCENARIOS = {
    "dp4": sc_dp4, "tp": sc_tp, "zero2": sc_zero2, "fsdp": sc_fsdp,
    "merge": sc_merge, "recompute": sc_recompute,
    "collectives": sc_collectives, "gpipe": sc_gpipe, "1f1b": sc_1f1b,
    "pipe_mem": sc_pipe_mem, "pipe_frozen": sc_pipe_frozen, "ring": sc_ring,
    "env": sc_env, "ddp": sc_ddp, "syncbn": sc_syncbn, "resnet": sc_resnet,
    "localsgd": sc_localsgd, "localsgd_ckpt": sc_localsgd_ckpt,
    "fp16": sc_fp16, "ckpt_port": sc_ckpt_port, "ckpt_ref": sc_ckpt_ref,
    "fleet": sc_fleet,
}
