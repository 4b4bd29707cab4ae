"""ShardedTrainStep (counterpart of paddle_tpu/parallel/train_step.py).

The reference compiles one SPMD step over a device mesh: parameters and
optimizer state carry ``PartitionSpec``s and GSPMD inserts every
collective.  The port runs one process per rank (the ``parallel`` module
docstring has the model of execution) on ``jit.TrainStep``'s program
machinery: one static-shape program per batch signature, captured as a
CUDA graph on the card, whose body here is

1. the rank's rows of the global batch (axis 0 over ``dp``);
2. every sharded parameter gathered whole from its blocks (all-gathers
   along its spec's axes), swapped in as the parameter's data; under
   ZeRO stage 3 each unit's parameters are gathered only while that unit
   runs (``_Units``: every recompute stage, a GPT block, is a unit and a
   recompute region, the rest of the model is the root unit) and gathered
   again for its backward, so the whole model is never held at once;
3. the forward and backward of ``TrainStep`` (AMP at
   ``strategy.amp_configs.level``, where the reference's sharded step
   always runs O1; recompute; ``accum_steps`` micro-batches), with every
   training BatchNorm's batch statistics over the ``dp`` group
   (``ops.fused_bn_act.stats_group``: K5's and K7's sums all-reduced
   between the kernels) and the running statistics left as they are, as
   the reference's sharded step leaves them;
4. the gradients averaged over ``dp``: a parameter sharded over ``dp``
   takes its block by a reduce-scatter along that dimension, the others
   go through averaging all-reduces (``ReduceOp.AVG``) in buckets of
   25 MB (in bf16 under ``fp16_allreduce``); a block along
   ``tp`` / ``ep`` is sliced from the gradient, which those ranks share;
5. the optimizer update on each rank's blocks: a sharded parameter and
   its moments are held only as this rank's block between steps (stage
   3 / tensor / expert parallel); under ZeRO-1/2 the moments are held as
   ``apply_fsdp``'s block over ``dp``, the update writes the parameter's
   block and an all-gather writes the whole parameter back;
6. the loss averaged over ``dp``.

``guard`` selects the old state on the device when the loss or the global
gradient norm (the blocks' squares summed over their axes) is not
finite.  ``save_checkpoint`` has each rank write the blocks it owns in the
reference's layout; ``restore_checkpoint`` gives each rank its blocks,
from any topology.  A sparse-gradient embedding weight is refused (a
row-sharded table trains through ``jit.TrainStep``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import weakref

import torch
import torch.distributed as dist

from ..core import buffer_updates as _bufup
from ..core import recompute as _recompute
from ..jit import TrainStep
from ..ops import fused_bn_act as _fbn
from ..optimizer.functional import update_in_place
from ..utils import faults as _faults
from . import sharding as shd
from .mesh import NamedSharding, P, get_mesh
from .strategy import DistributedStrategy

__all__ = ["ShardedTrainStep"]

_BUCKET_BYTES = 25 << 20   # the reference Reducer's default bucket


class Layout:
    """How one tensor is split over the mesh: ``(dim, axis)`` for every
    dimension its spec shards over an axis of more than one rank."""

    def __init__(self, mesh, spec, shape):
        self.mesh = mesh
        self.shape = tuple(shape)
        self.spec = spec
        self.dims = []
        for d, e in enumerate(tuple(spec)[:len(shape)]):
            if e is None:
                continue
            if isinstance(e, (tuple, list)):
                raise NotImplementedError(
                    f"a dimension sharded over several axes ({e}) is not "
                    "ported; give each axis its own dimension")
            if mesh.shape[e] > 1:
                self.dims.append((d, e))

    def __bool__(self):
        return bool(self.dims)

    @property
    def dp_dim(self) -> Optional[int]:
        return next((d for d, a in self.dims if a == "dp"), None)

    def block(self, t, axes=None):
        """This rank's block of the whole tensor ``t`` along the layout's
        axes (or only ``axes``), a view."""
        for d, a in self.dims:
            if axes is None or a in axes:
                n = t.shape[d] // self.mesh.shape[a]
                t = t.narrow(d, self.mesh.coord(a) * n, n)
        return t

    def index(self):
        """This rank's block of the whole tensor, as slices."""
        idx = [slice(0, n) for n in self.shape]
        for d, a in self.dims:
            n = self.shape[d] // self.mesh.shape[a]
            c = self.mesh.coord(a)
            idx[d] = slice(c * n, (c + 1) * n)
        return tuple(idx)

    def owner(self) -> bool:
        """Whether this rank writes its block to a checkpoint: the replica
        with coordinate 0 on every axis the layout does not split."""
        mine = {a for _, a in self.dims}
        return all(self.mesh.coord(a) == 0 for a in self.mesh.shape
                   if a not in mine)

    def gather(self, x):
        """The whole tensor from this rank's block ``x``: one all-gather
        per sharded dimension, the last one first."""
        for d, a in reversed(self.dims):
            g = self.mesh.group(a)
            n = self.mesh.shape[a]
            xt = x.movedim(d, 0).contiguous()
            out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                              dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, xt, group=g)
            x = out.movedim(0, d)
        return x


# ZeRO stage 3's gathered copies: bytes alive now and at most (a process's
# count; ``reset_gather_stats`` zeroes it)
gather_stats = {"alive": 0, "peak": 0, "gathers": 0}


def reset_gather_stats():
    gather_stats.update(alive=0, peak=0, gathers=0)


def _note_gathered(t):
    n = t.numel() * t.element_size()
    gather_stats["alive"] += n
    gather_stats["gathers"] += 1
    gather_stats["peak"] = max(gather_stats["peak"], gather_stats["alive"])

    def gone():
        gather_stats["alive"] -= n
    weakref.finalize(t, gone)
    return t


class _Gather(torch.autograd.Function):
    """The whole parameter from this rank's block; its gradient goes,
    whole, to ``virtual`` (a whole-shaped leaf of one element's storage
    that stands for the parameter in the step's ``autograd.grad``), so the
    gradients and their reduction are those of the up-front gather."""

    @staticmethod
    def forward(ctx, virtual, block, lay):
        return _note_gathered(lay.gather(block))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Units:
    """ZeRO stage 3's gather schedule over the model's units: each
    recompute stage (a GPT block) not inside another is a unit, and the
    model's remaining sharded parameters (embeddings, tied head, final
    norm) are the root unit.  While ``active``, a unit's forward pre-hook
    puts its parameters' gathered wholes in place of the Parameters (in
    the owning modules' ``_parameters``) and its post-hook puts the
    Parameters back: nothing but autograd then holds a gathered copy.
    Inside a stage the recompute region drops everything it saved and
    gathers again when it is recomputed for the backward; what the root
    unit's ops save of a gathered copy is packed as its name and gathered
    again when the backward unpacks it (``saved``)."""

    def __init__(self, model, layouts):
        self.layouts = layouts
        self.virtual: Dict[str, torch.Tensor] = {}
        self.active = False
        owner = {}
        for mname, mod in model.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                key = f"{mname}.{pname}" if mname else pname
                if key in layouts:
                    owner[key] = (mod, pname)
        self.units = []
        taken = set()
        for mname, mod in model.named_modules():
            if not getattr(mod, "_remat_stage", False) or any(
                    mname.startswith(t + ".") for t in taken):
                continue
            keys = [k for k in owner if k.startswith(mname + ".")]
            taken.add(mname)
            if keys:
                self.units.append((mod, [(k,) + owner[k] for k in keys]))
        inner = {k for _, ks in self.units for k, _, _ in ks}
        self.root = [(k,) + owner[k] for k in owner if k not in inner]
        self.units.append((model, self.root))
        self._live: Dict[int, str] = {}
        for mod, keys in self.units:
            mod.register_forward_pre_hook(self._pre(keys))
            mod.register_forward_hook(self._post(keys))

    def _pre(self, keys):
        def hook(mod, inputs):
            if not self.active:
                return None
            for k, owner, pname in keys:
                w = _Gather.apply(self.virtual[k], owner._parameters[pname],
                                  self.layouts[k])
                if keys is self.root:
                    self._live[w.untyped_storage().data_ptr()] = k
                owner._parameters[pname] = w
            return None
        return hook

    def _post(self, keys):
        def hook(mod, inputs, output):
            if self.active:
                for k, owner, pname in keys:
                    owner._parameters[pname] = self.params[k]
                if keys is self.root:
                    # nothing of the root saves after its forward; a freed
                    # copy's address may be reused
                    self._live.clear()
            return None
        return hook

    @contextlib.contextmanager
    def step(self, params):
        """The step's forward and backward: ``params`` maps each sharded
        key to its Parameter; yields the whole-shaped leaves to take
        gradients of in their place."""
        self.params = params
        self.virtual = {
            k: torch.empty((), dtype=params[k].dtype,
                           device=params[k].device).expand(
                               lay.shape).requires_grad_()
            for k, lay in self.layouts.items()}
        self.active = True
        from torch.utils.checkpoint import set_checkpoint_early_stop
        try:
            # a recomputation runs to its end, post-hook included: stopped
            # early it would leave its gathered copies in place
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack), \
                    _recompute.recompute_policy("stages", None), \
                    set_checkpoint_early_stop(False):
                yield self.virtual
        finally:
            self.active = False
            for _, keys in self.units:
                for k, owner, pname in keys:
                    owner._parameters[pname] = params[k]
            self.virtual, self._live, self.params = {}, {}, None

    def _pack(self, t):
        k = self._live.get(t.untyped_storage().data_ptr())
        if k is None:
            return t
        return (k, t.shape, t.stride(), t.storage_offset())

    def _unpack(self, packed):
        if isinstance(packed, torch.Tensor):
            return packed
        k, shape, stride, offset = packed
        lay = self.layouts[k]
        w = _note_gathered(lay.gather(self.params[k].detach()))
        return w.as_strided(shape, stride, offset)


def _reduce_scatter_mean(g, d: int, group, n: int, wire):
    """The mean over ``group`` of ``g``, this rank's part of dim ``d``."""
    gt = g.movedim(d, 0).contiguous().to(wire)
    out = torch.empty((gt.shape[0] // n,) + tuple(gt.shape[1:]),
                      dtype=wire, device=g.device)
    dist.reduce_scatter_tensor(out, gt, group=group)
    return (out.to(g.dtype) / n).movedim(0, d)


class ShardedTrainStep(TrainStep):
    """``step(*batch) -> loss`` over a mesh: every rank is handed the same
    global batch and returns the global loss (module docstring)."""

    def __init__(self, model, loss_fn, optimizer,
                 strategy: Optional[DistributedStrategy] = None, mesh=None,
                 batch_spec=None, guard: bool = False, accum_steps: int = 1):
        st = self.strategy = strategy or DistributedStrategy()
        self.mesh = mesh or get_mesh(create_default=True)
        k_steps = (st.gradient_merge_configs.k_steps if st.gradient_merge
                   else 1)
        if int(accum_steps) < 1:
            raise ValueError("ShardedTrainStep: accum_steps must be >= 1")
        if int(accum_steps) > 1:
            if st.gradient_merge and k_steps != int(accum_steps):
                raise ValueError(
                    "ShardedTrainStep: accum_steps and "
                    "strategy.gradient_merge_configs.k_steps disagree "
                    f"({accum_steps} vs {k_steps})")
            k_steps = int(accum_steps)
        fsdp = st.sharding and st.sharding_configs.stage >= 3
        self._zero12 = st.sharding and st.sharding_configs.stage in (1, 2)
        self._fp16_allreduce = bool(st.fp16_allreduce)
        if self._fp16_allreduce and (fsdp or st.tensor_parallel
                                     or st.sequence_parallel or st.pipeline):
            raise ValueError(
                "fp16_allreduce composes with plain DP (optionally ZeRO-1/2)"
                " only — disable sharding stage 3 / tensor_parallel /"
                " sequence_parallel / pipeline")
        super().__init__(model, loss_fn, optimizer,
                         amp_level=st.amp_configs.level if st.amp else None,
                         amp_dtype=st.amp_configs.dtype, remat=st.recompute,
                         guard=guard, accum_steps=k_steps)
        if self._sparse:
            raise NotImplementedError(
                "ShardedTrainStep: sparse-gradient embedding weights "
                f"{sorted(self._sparse)} are not taken by the sharded step "
                "(its dp split of the batch would need the lookups' rows "
                "exchanged); build the Embedding with sparse=False, or "
                "train a row-sharded table (embedding.ShardedEmbedding) "
                "through jit.TrainStep")
        self._merge_sum = (st.gradient_merge
                           and not st.gradient_merge_configs.avg)
        state = model.state_dict(keep_vars=True)
        mesh = self.mesh
        self.param_specs = shd.param_specs(
            {k: tuple(v.shape) for k, v in state.items()}, mesh,
            tensor_parallel=st.tensor_parallel, fsdp=fsdp,
            custom_rule=st.sharding_rule, expert_parallel=st.expert_parallel)
        self.param_shardings = shd.shardings_of(self.param_specs, mesh)
        if batch_spec is None:
            batch_spec = P("dp", "sp") if st.sequence_parallel else P("dp")
        self.batch_spec = batch_spec
        # layouts of the trainable parameters (frozen ones and buffers stay
        # whole on every rank) and, under ZeRO-1/2, of their moments
        self._layouts: Dict[str, Layout] = {}
        self._moments: Dict[str, Layout] = {}
        for k in self._trainable:
            shape = tuple(state[k].shape)
            lay = Layout(mesh, self.param_specs[k], shape)
            if lay:
                self._layouts[k] = lay
            if self._zero12:
                spec = shd.apply_fsdp(self.param_specs[k], shape, mesh)
                mlay = Layout(mesh, spec if spec is not None else P(), shape)
                if mlay.dp_dim is not None and not lay:
                    self._moments[k] = mlay
        self._units = (_Units(model, self._layouts)
                       if fsdp and self._layouts else None)
        if self._units is not None:
            # stage 3 recomputes every stage region (module docstring),
            # never the whole loss: one region would gather every block
            # again at the start of the backward
            self._remat = False
        self._dp = mesh.shape["dp"]
        self._dp_group = mesh.group("dp")
        self._wire = torch.bfloat16 if self._fp16_allreduce else None
        self._placed = False

    # -- placement -----------------------------------------------------------
    @torch.no_grad()
    def place_params(self):
        """Keep only this rank's block of every sharded parameter (the
        parameter's data becomes the block)."""
        if self._placed:
            return
        state = self.model.state_dict(keep_vars=True)
        for k, lay in self._layouts.items():
            p = state[k]
            p.data = lay.block(p.data).contiguous().clone()
        self._placed = True

    def init_opt_state(self, state):
        """Optimizer state of each trainable parameter's block (ZeRO-1/2:
        of the moments' block over ``dp``)."""
        out = {}
        for k in self._trainable:
            t = state[k]
            if k in self._moments:
                t = self._moments[k].block(t).contiguous()
            out[k] = self.optimizer.init_state(t)
        return out

    def _setup(self):
        self.place_params()
        super()._setup()
        # each data-parallel rank draws its own dropout masks
        self._gen.manual_seed(self._gen.initial_seed()
                              + 1000003 * self.mesh.coord("dp"))

    def _staged(self, batch, lr, step_no):
        self.place_params()
        return super()._staged(batch, lr, step_no)

    # -- the program ---------------------------------------------------------
    def _local(self, batch):
        """The rank's rows (and columns) of each batch tensor, by the batch
        spec's axes; ``sp`` is not split (module docstring)."""
        out = []
        for b in batch:
            for d, e in enumerate(tuple(self.batch_spec)[:b.dim()]):
                if e is None or e == "sp" or self.mesh.shape[e] == 1:
                    continue
                n = self.mesh.shape[e]
                if b.shape[d] % n:
                    raise ValueError(
                        f"ShardedTrainStep: batch dim {d} of size "
                        f"{b.shape[d]} does not divide over {e}={n}")
                size = b.shape[d] // n
                b = b.narrow(d, self.mesh.coord(e) * size, size)
            out.append(b)
        return tuple(out)

    def _mean_dp(self, x):
        if self._dp_group is None:
            return x
        x = x.float().clone()
        dist.all_reduce(x, op=dist.ReduceOp.AVG, group=self._dp_group)
        return x

    def _all_reduce_buckets(self, grads: Dict[str, torch.Tensor]):
        """The mean over ``dp`` of each gradient, through all-reduces of
        buckets of at most 25 MB of one dtype."""
        if self._dp_group is None or not grads:
            return grads
        out, bucket, size = {}, [], 0

        def flush():
            nonlocal bucket, size
            if not bucket:
                return
            wire = self._wire or grads[bucket[0]].dtype
            flat = torch.cat([grads[k].reshape(-1).to(wire)
                              for k in bucket])
            dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=self._dp_group)
            for k, part in zip(bucket, flat.split(
                    [grads[k].numel() for k in bucket])):
                out[k] = part.to(grads[k].dtype).view(grads[k].shape)
            bucket, size = [], 0
        for k in sorted(grads, key=lambda n: str(grads[n].dtype)):
            g = grads[k]
            if bucket and (g.dtype != grads[bucket[0]].dtype
                           or size + g.numel() * g.element_size()
                           > _BUCKET_BYTES):
                flush()
            bucket.append(k)
            size += g.numel() * g.element_size()
        flush()
        return out

    def _reduce_grads(self, grads):
        """Each gradient averaged over ``dp`` and cut to the block this
        rank updates."""
        whole, out = {}, {}
        wire = self._wire
        for k, g in grads.items():
            lay = self._layouts.get(k) or self._moments.get(k)
            if lay is None:
                whole[k] = g
                continue
            g = lay.block(g, axes={a for _, a in lay.dims if a != "dp"})
            d = lay.dp_dim
            if d is None:
                whole[k] = g.contiguous()
            else:
                out[k] = _reduce_scatter_mean(g, d, self._dp_group, self._dp,
                                              wire or g.dtype)
        out.update(self._all_reduce_buckets(whole))
        return {k: out[k] for k in grads}

    def _verdict(self, loss, grads):
        """(global gradient norm, finite) with every block's squares summed
        over the axes it is split along."""
        dev = loss.device
        own = torch.zeros((), dtype=torch.float32, device=dev)
        split: Dict[tuple, torch.Tensor] = {}
        for k, g in grads.items():
            sq = torch.sum(g.float() * g.float())
            lay = self._layouts.get(k) or self._moments.get(k)
            axes = tuple(sorted(a for _, a in lay.dims)) if lay else ()
            if axes:
                split[axes] = split.get(axes, 0) + sq
            else:
                own = own + sq
        for axes, sq in split.items():
            sq = sq.clone()
            for a in axes:
                dist.all_reduce(sq, group=self.mesh.group(a))
            own = own + sq
        gnorm = torch.sqrt(own)
        return gnorm, torch.isfinite(loss) & torch.isfinite(gnorm)

    def _step_program(self, lr, step_no, nan_window=None, **inputs):
        state = self.model.state_dict(keep_vars=True)
        params = {k: state[k] for k in self._trainable}
        batch = self._local(tuple(v for k, v in inputs.items()
                                  if k.startswith("b")))
        blocks = {}
        if self._units is not None:
            with self._units.step(
                    {k: params[k] for k in self._layouts}) as whole, \
                    _fbn.stats_group(self.mesh.group("dp")), \
                    _bufup.dropped():
                loss, grads, outs = self._micro_grads(
                    {**params, **whole}, batch)
        else:
            try:
                for k, lay in self._layouts.items():
                    blocks[k] = params[k].data
                    params[k].data = lay.gather(blocks[k])
                with _fbn.stats_group(self.mesh.group("dp")), \
                        _bufup.dropped():
                    loss, grads, outs = self._micro_grads(params, batch)
            finally:
                for k, b in blocks.items():
                    params[k].data = b
        loss = self._mean_dp(loss)
        if self._merge_sum:
            grads = {k: g * self.accum_steps for k, g in grads.items()}
        grads = self._reduce_grads(grads)
        if nan_window is not None:
            grads = _faults.poison_grads(grads, step_no, window=nan_window)
        with torch.no_grad():
            ok = None
            if self._guard:
                gnorm, ok = self._verdict(loss, grads)
                self._gnorm.copy_(gnorm)
                self._ok.copy_(ok)
            targets = {k: p.detach() for k, p in params.items()}
            for k, mlay in self._moments.items():
                targets[k] = mlay.block(targets[k]).contiguous()
            update_in_place(self.optimizer, targets, grads, self._opt_state,
                            lr, step_no, self._decay, ok)
            for k, mlay in self._moments.items():
                params[k].detach().copy_(mlay.gather(targets[k]))
        return (loss, *outs)

    # -- checkpoints ---------------------------------------------------------
    def _tree(self):
        """{"params", "opt"}: blocks as ``checkpoint.Shard``s, whole
        tensors as they are."""
        from ..distributed.checkpoint import Shard
        self.place_params()
        if self._gen is None:
            self._setup()
        state = self.model.state_dict(keep_vars=True)

        def leaf(t, lay):
            if lay is None:
                return t.detach()
            return Shard(t.detach(), lay.shape, lay.index(),
                         list(lay.spec), lay.owner())
        params = {k: leaf(v, self._layouts.get(k)) for k, v in state.items()}
        opt = {}
        for k, slots in self._opt_state.items():
            lay = self._layouts.get(k) or self._moments.get(k)
            opt[k] = {s: leaf(t, lay if lay is not None and
                              t.dim() == len(lay.shape) else None)
                      for s, t in slots.items()}
        return {"params": params, "opt": opt}

    def save_checkpoint(self, directory, step=None, extra_meta=None,
                        scaler=None, data_cursor=None):
        """Each rank writes the blocks it owns (a replicated tensor once,
        by rank 0), in the reference's layout; rank 0 publishes the
        manifest after a barrier.  Returns the step directory."""
        from ..distributed import checkpoint as dck
        tree = self._tree()
        if self.accum_steps > 1:
            extra_meta = dict(extra_meta or {})
            extra_meta.setdefault("accum_steps", self.accum_steps)
        return dck.save_train_state(
            directory, tree["params"], tree["opt"],
            step if step is not None else self.optimizer._step_count,
            extra_meta, optimizer=self.optimizer, scaler=scaler,
            data_cursor=data_cursor, generator=self._gen)

    @torch.no_grad()
    def restore_checkpoint(self, directory, scaler=None):
        """This rank's blocks of the newest checkpoint under ``directory``
        (written from any topology, by the port or the reference), written
        in place; returns the meta, or None."""
        from ..distributed import checkpoint as dck
        from ..distributed.checkpoint import Shard
        tree = self._tree()
        mesh = self.mesh

        def sharding(leaf):
            return NamedSharding(mesh, P(*leaf.spec) if isinstance(
                leaf, Shard) else P())
        shardings = {
            "params": {k: sharding(v) for k, v in tree["params"].items()},
            "opt": {k: {s: sharding(t) for s, t in slots.items()}
                    for k, slots in tree["opt"].items()}}
        res = dck.restore_sharded(directory, mesh=mesh, shardings=shardings)
        if res is None:
            return None
        got, step, extra = res

        def put(dst, src):
            t = dst.data if isinstance(dst, Shard) else dst
            t.copy_(src.to(t.dtype))
        for k, v in got["params"].items():
            put(tree["params"][k], v)
        for k, slots in got.get("opt", {}).items():
            for s, v in slots.items():
                if k in tree["opt"] and s in tree["opt"][k]:
                    put(tree["opt"][k][s], v)
        return dck.restore_train_extras(self.optimizer, step, extra, scaler,
                                        generator=self._gen)

    def describe_shardings(self) -> Dict[str, str]:
        return {k: str(v) for k, v in self.param_specs.items()}

