"""Pipeline parallelism: GPipe and 1F1B over the ``pp`` mesh axis
(counterpart of paddle_tpu/parallel/pipeline.py).

The reference stacks the identical transformer blocks on a leading axis
sharded over ``pp`` and runs the tick loop inside one ``shard_map``, the
hand-offs ``lax.ppermute``.  The port runs one process per rank: the
``pp`` rank ``s`` holds its stage's ``layers_per_stage`` blocks (the
model's own block modules; the other stages' block parameters are freed
on this rank at the first step) and the replicated rest (embeddings, the
final norm, the tied head).  Activations go to the next stage and their
gradients to the one before by ``batch_isend_irecv`` on the ``pp`` group,
one batch of sends and receives per tick.

- ``"gpipe"``: every micro-batch forward (tick t: stage s runs
  micro-batch t - s), then every micro-batch backward in reverse order;
  with ``remat`` a stage's forward keeps only its input
  (``core.recompute``).  The head and loss of a micro-batch run on the
  last stage when its forward arrives, and its graph waits for the
  backward.
- ``"1f1b"``: the reference's combined ticks: tick t runs the forward of
  micro-batch t - s without a graph, stashing its input, seeds the head's
  backward on the last stage at once, and runs the backward of micro-batch
  t - 2(p - 1) + s by recomputing the stage from the stashed input, so
  in-flight activations are bounded by the stash.
- The loss is the mean over the micro-batches, summed over ``pp`` (only
  the last stage holds it) and averaged over ``dp``; the rest's gradients
  (the embeddings from stage 0, the head from the last stage) are summed
  over ``pp``; every gradient is averaged over ``dp``.  Each ``dp`` rank
  takes its rows of every micro-batch, as the reference shards the
  micro-batched ids on axis 1.
- A block parameter is updated only when it is trainable in every layer
  (the reference's per-suffix rule); the rest's frozen parameters stay.
- ``memory_stats`` runs one step's forward and backward on the current
  state with nothing updated and the random stream put back, and counts
  the peak bytes of tensors saved for backward
  (``torch.autograd.graph.saved_tensors_hooks``) as ``temp_bytes``; the
  reference reads XLA's buffer assignment without running.
- The step runs eagerly (not captured): its hand-offs are host-ordered
  point-to-point operations.
"""
from __future__ import annotations

import contextlib
import re
import weakref
from typing import Callable, Dict

import torch
import torch.distributed as dist

from ..core import recompute as _recompute
from ..core import rng
from ..optimizer.functional import decay_flags, update_in_place

__all__ = ["stack_block_params", "unstack_block_params",
           "PipelinedTrainStep", "gpt_pipeline_step"]


def stack_block_params(state: Dict[str, torch.Tensor], block_re: str
                       ) -> tuple:
    """(stacked_blocks, rest): ``block_re`` captures the layer index as
    group 1 and the suffix as group 2; stacked maps suffix -> tensor with
    a leading layer axis."""
    pat = re.compile(block_re)
    per_layer: Dict[int, Dict[str, torch.Tensor]] = {}
    rest = {}
    for k, v in state.items():
        m = pat.match(k)
        if m:
            per_layer.setdefault(int(m.group(1)), {})[m.group(2)] = v
        else:
            rest[k] = v
    if not per_layer:
        raise ValueError(f"no params matched block pattern {block_re!r}")
    n = len(per_layer)
    stacked = {s: torch.stack([per_layer[i][s] for i in range(n)])
               for s in sorted(per_layer[0])}
    return stacked, rest


def unstack_block_params(stacked: Dict[str, torch.Tensor], prefix_fmt: str
                         ) -> Dict[str, torch.Tensor]:
    """Inverse of ``stack_block_params``: ``prefix_fmt`` like
    ``'gpt.blocks.{}.{}'``."""
    out = {}
    for suffix, arr in stacked.items():
        for i in range(arr.shape[0]):
            out[prefix_fmt.format(i, suffix)] = arr[i]
    return out


class _SavedBytes:
    """The peak bytes of tensors saved for backward inside ``counting``."""

    def __init__(self):
        self.live = self.peak = 0

    @contextlib.contextmanager
    def counting(self):
        class Held:
            __slots__ = ("t", "__weakref__")

        def done(n):
            self.live -= n

        def pack(t):
            h = Held()
            h.t = t
            n = t.numel() * t.element_size()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(h, done, n)
            return h
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda h: h.t):
            yield


class PipelinedTrainStep:
    """GPipe / 1F1B train step for block-stacked LMs:
    ``step(input_ids, labels) -> loss`` (module docstring)."""

    def __init__(self, model, optimizer, mesh, block_re: str, block_module,
                 embed_fn: Callable, head_loss_fn: Callable,
                 n_micro: int = 4, remat: bool = True,
                 schedule: str = "gpipe"):
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pipeline schedule {schedule!r}")
        self.model = model
        self.optimizer = optimizer
        self.mesh = mesh
        self.block_re = block_re
        self.block_module = block_module   # the model's own blocks run
        self.embed_fn = embed_fn
        self.head_loss_fn = head_loss_fn
        self.n_micro = int(n_micro)
        self.remat = remat
        self.schedule = schedule
        self.n_stages = mesh.shape["pp"]
        self.dp = mesh.shape["dp"]
        self.stage = mesh.coord("pp")
        self._pp = mesh.group("pp")
        self._dpg = mesh.group("dp")
        self._opt_state = None
        self._gen = None
        state = model.state_dict(keep_vars=True)
        pat = re.compile(block_re)
        layers: Dict[int, Dict[str, str]] = {}
        prefix: Dict[int, str] = {}
        rest = []
        for k in state:
            m = pat.match(k)
            if m:
                i = int(m.group(1))
                layers.setdefault(i, {})[m.group(2)] = k
                prefix[i] = k[:m.start(2)].rstrip(".")
            else:
                rest.append(k)
        if not layers:
            raise ValueError(f"no params matched block pattern {block_re!r}")
        n_layers = len(layers)
        if n_layers % self.n_stages:
            raise ValueError(
                f"{n_layers} layers not divisible by {self.n_stages} stages")
        self.layers_per_stage = lps = n_layers // self.n_stages
        self._mine = list(range(self.stage * lps, (self.stage + 1) * lps))
        self._layer_names = layers
        self._blocks = [model.get_submodule(prefix[i]) for i in self._mine]

        def trainable(k):
            v = state[k]
            return isinstance(v, torch.nn.Parameter) and v.requires_grad
        suffix_ok = {s: all(trainable(layers[i][s]) for i in layers)
                     for s in layers[0]}
        self._train_blocks = [layers[i][s] for i in self._mine
                              for s in layers[i] if suffix_ok[s]]
        self._train_rest = [k for k in rest if trainable(k)]
        self._rest = {k: state[k] for k in rest}
        self._freed = False

    # -- state ---------------------------------------------------------------
    def _free_other_stages(self):
        """Drop this rank's copies of the other stages' block parameters."""
        if self._freed or self.n_stages == 1:
            self._freed = True
            return
        state = self.model.state_dict(keep_vars=True)
        self._full_shapes = {}
        for i, names in self._layer_names.items():
            if i in self._mine:
                continue
            for k in names.values():
                t = state[k]
                self._full_shapes[k] = tuple(t.shape)
                t.data = torch.empty(0, dtype=t.dtype, device=t.device)
        self._freed = True

    def init(self):
        self._free_other_stages()
        state = self.model.state_dict(keep_vars=True)
        names = self._train_blocks + self._train_rest
        self._params = {k: state[k] for k in names}
        self._opt_state = {k: self.optimizer.init_state(state[k].detach())
                           for k in names}
        self._decay = decay_flags(self.optimizer, names)
        dev = next(iter(state.values())).device
        if self._pp is not None and self.n_stages > 1:
            # NCCL makes a group's communicator at its first collective,
            # which every rank of the group must join: a tick's
            # point-to-point batch involves only some stages
            dist.all_reduce(torch.zeros(1, device=dev), group=self._pp)
        self._gen = rng.step_generator(dev)
        self._gen.manual_seed(self._gen.initial_seed()
                              + 1000003 * self.mesh.coord("dp"))
        self._device = dev

    # -- the schedules -----------------------------------------------------
    def _run_stage(self, h):
        def run(h):
            for blk in self._blocks:
                h = blk(h)
            return h
        with rng.generator_scope(self._gen), _recompute.step_forward():
            if self.remat and torch.is_grad_enabled():
                return _recompute.checkpoint(run)(h)
            return run(h)

    def _micro(self, input_ids, labels):
        """(n_micro, rows, ...) micro-batches: this ``dp`` rank's rows of
        each."""
        b = input_ids.shape[0]
        if b % self.n_micro:
            raise ValueError(f"batch {b} does not divide into "
                             f"{self.n_micro} micro-batches")
        mb = b // self.n_micro
        ids = input_ids.reshape((self.n_micro, mb)
                                + tuple(input_ids.shape[1:]))
        lbl = labels.reshape((self.n_micro, mb) + tuple(labels.shape[1:]))
        if self.dp > 1:
            if mb % self.dp:
                raise ValueError(f"micro-batch of {mb} rows does not divide "
                                 f"over dp={self.dp}")
            r = mb // self.dp
            c = self.mesh.coord("dp")
            ids, lbl = ids[:, c * r:(c + 1) * r], lbl[:, c * r:(c + 1) * r]
        return ids.to(self._device), lbl.to(self._device)

    def _exchange(self, sends, recvs):
        """One batch of point-to-point operations on the ``pp`` group:
        ``sends`` [(tensor, stage)], ``recvs`` [(buffer, stage)]."""
        ops = [dist.P2POp(dist.isend, t.contiguous(),
                          dist.get_global_rank(self._pp, s), group=self._pp)
               for t, s in sends]
        ops += [dist.P2POp(dist.irecv, b, dist.get_global_rank(self._pp, s),
                           group=self._pp) for b, s in recvs]
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()

    def _head(self, h, lbl):
        """(loss / n_micro, d loss / d h, the rest's gradients)."""
        rest = [self._rest[k] for k in self._train_rest]
        with torch.enable_grad():
            hh = h.detach().requires_grad_()
            with rng.generator_scope(self._gen):
                loss = self.head_loss_fn(self._rest, hh, lbl) / self.n_micro
            gs = torch.autograd.grad(loss, [hh] + rest, allow_unused=True)
        return loss.detach(), gs[0], gs[1:]

    def _grads(self, input_ids, labels):
        """(loss, {name: gradient}) of one step, before the update."""
        ids, lbl = self._micro(input_ids, labels)
        m, p, s = self.n_micro, self.n_stages, self.stage
        first, last = s == 0, s == p - 1
        blocks = [self._params[k] for k in self._train_blocks]
        rest_p = [self._rest[k] for k in self._train_rest]
        g_blocks = [torch.zeros_like(t, dtype=torch.float32) for t in blocks]
        g_rest = [torch.zeros_like(t, dtype=torch.float32) for t in rest_p]
        loss = torch.zeros((), dtype=torch.float32, device=self._device)
        emb = None
        if first:
            with torch.enable_grad(), rng.generator_scope(self._gen):
                emb = self.embed_fn(self._rest, ids)
            d_emb = [None] * m
        shape = tuple(ids.shape[1:]) + (self._blocks[0].hidden_size,)
        dtype = emb.dtype if emb is not None else \
            self._rest["gpt.word_embeddings.weight"].dtype \
            if "gpt.word_embeddings.weight" in self._rest else torch.float32

        def add(acc, gs):
            for a, g in zip(acc, gs):
                if g is not None:
                    a.add_(g.float())

        def stage_input(f, fwd_in):
            return emb[f].detach() if first else fwd_in[f]

        def recompute_backward(h_in, dh):
            """The stage's gradients from its stashed input: the forward
            recomputed with a graph, then its backward."""
            with torch.enable_grad():
                x = h_in.detach().requires_grad_()
                gs = torch.autograd.grad(self._run_stage(x), [x] + blocks, dh,
                                         allow_unused=True)
            add(g_blocks, gs[1:])
            return gs[0]

        fwd_in, bwd_in = {}, {}
        if self.schedule == "1f1b":
            stash = {}
            for t in range(m + 2 * (p - 1)):
                sends, recvs = [], []
                f = t - s
                dh_last = None
                if 0 <= f < m:
                    h_in = stage_input(f, fwd_in)
                    fwd_in.pop(f, None)
                    stash[f] = h_in
                    with torch.no_grad():
                        h_out = self._run_stage(h_in)
                    if last:
                        lf, dh_last, gr = self._head(h_out, lbl[f])
                        loss += lf
                        add(g_rest, gr)
                    else:
                        sends.append((h_out, s + 1))
                j = t - 2 * (p - 1) + s
                if 0 <= j < m:
                    dh = dh_last if last else bwd_in.pop(j)
                    dx = recompute_backward(stash.pop(j), dh.to(dtype))
                    if first:
                        d_emb[j] = dx
                    else:
                        sends.append((dx, s - 1))
                if not first and 0 <= t + 1 - s < m:
                    fwd_in[t + 1 - s] = torch.empty(shape, dtype=dtype,
                                                    device=self._device)
                    recvs.append((fwd_in[t + 1 - s], s - 1))
                jn = t + 1 - 2 * (p - 1) + s
                if not last and 0 <= jn < m:
                    bwd_in[jn] = torch.empty(shape, dtype=dtype,
                                             device=self._device)
                    recvs.append((bwd_in[jn], s + 1))
                self._exchange(sends, recvs)
        else:   # gpipe
            graphs = {}
            heads = {}
            for t in range(m + p - 1):
                sends, recvs = [], []
                f = t - s
                if 0 <= f < m:
                    h_in = stage_input(f, fwd_in)
                    fwd_in.pop(f, None)
                    with torch.enable_grad():
                        x = h_in.detach().requires_grad_()
                        h_out = self._run_stage(x)
                    graphs[f] = (x, h_out)
                    if last:
                        with torch.enable_grad(), \
                                rng.generator_scope(self._gen):
                            hl = self.head_loss_fn(self._rest, h_out,
                                                   lbl[f]) / m
                        heads[f] = hl
                        loss += hl.detach()
                    else:
                        sends.append((h_out.detach(), s + 1))
                if not first and 0 <= t + 1 - s < m:
                    fwd_in[t + 1 - s] = torch.empty(shape, dtype=dtype,
                                                    device=self._device)
                    recvs.append((fwd_in[t + 1 - s], s - 1))
                self._exchange(sends, recvs)
            for u in range(m + p - 1):
                sends, recvs = [], []
                j = m - 1 - (u - (p - 1 - s))
                if 0 <= j < m:
                    x, h_out = graphs.pop(j)
                    with torch.enable_grad():
                        if last:
                            gs = torch.autograd.grad(
                                heads.pop(j), [x] + blocks + rest_p,
                                allow_unused=True)
                            add(g_rest, gs[1 + len(blocks):])
                        else:
                            gs = torch.autograd.grad(
                                h_out, [x] + blocks, bwd_in.pop(j).to(dtype),
                                allow_unused=True)
                    add(g_blocks, gs[1:1 + len(blocks)])
                    if first:
                        d_emb[j] = gs[0]
                    else:
                        sends.append((gs[0], s - 1))
                jn = m - 1 - (u + 1 - (p - 1 - s))
                if not last and 0 <= jn < m:
                    bwd_in[jn] = torch.empty(shape, dtype=dtype,
                                             device=self._device)
                    recvs.append((bwd_in[jn], s + 1))
                self._exchange(sends, recvs)
        if first:   # the embeddings' gradients from stage 0's input grads
            with torch.enable_grad():
                gs = torch.autograd.grad(emb, rest_p, torch.stack(d_emb),
                                         allow_unused=True)
            add(g_rest, gs)
        self._reduce(loss, g_rest, g_blocks)
        grads = dict(zip(self._train_blocks, g_blocks))
        grads.update(zip(self._train_rest, g_rest))
        return loss, grads

    def _reduce(self, loss, g_rest, g_blocks):
        """Sum the loss and the rest's gradients over ``pp``; average
        everything over ``dp``."""
        flat_rest = torch.cat([loss.reshape(1)] + [g.reshape(-1)
                                                   for g in g_rest])
        if self._pp is not None and self.n_stages > 1:
            dist.all_reduce(flat_rest, group=self._pp)
        flat = torch.cat([flat_rest] + [g.reshape(-1) for g in g_blocks])
        if self._dpg is not None:
            dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=self._dpg)
        parts = flat.split([1] + [g.numel() for g in g_rest]
                           + [g.numel() for g in g_blocks])
        loss.copy_(parts[0].view(()))
        for g, v in zip(g_rest + g_blocks, parts[1:]):
            g.copy_(v.view(g.shape))

    # -- the step ------------------------------------------------------------
    def __call__(self, input_ids, labels):
        if self._opt_state is None:
            self.init()
        opt = self.optimizer
        opt._step_count += 1
        loss, grads = self._grads(input_ids, labels)
        lr = torch.tensor(float(opt.get_lr()), dtype=torch.float32,
                          device=self._device)
        step_no = torch.tensor(opt._step_count, dtype=torch.int32,
                               device=self._device)
        with torch.no_grad():
            params = {k: self._params[k].detach() for k in grads}
            update_in_place(opt, params, {k: g.to(params[k].dtype)
                                          for k, g in grads.items()},
                            self._opt_state, lr, step_no, self._decay)
        return loss

    def memory_stats(self, input_ids, labels) -> dict:
        """One step's forward and backward on the current state, nothing
        updated and the random stream put back: the peak bytes of tensors
        saved for backward (``temp_bytes``), and the bytes of the state the
        step reads and writes in place."""
        if self._opt_state is None:
            self.init()
        gen = self._gen.get_state()
        counter = _SavedBytes()
        try:
            with counter.counting():
                self._grads(input_ids, labels)
        finally:
            self._gen.set_state(gen)

        def nbytes(ts):
            return int(sum(t.numel() * t.element_size() for t in ts))
        state = nbytes(list(self._params.values()) + [
            t for slots in self._opt_state.values() for t in slots.values()])
        batch = nbytes([input_ids, labels])
        return {"temp_bytes": int(counter.peak),
                "argument_bytes": state + batch,
                "output_bytes": state + 4, "alias_bytes": state}

    @torch.no_grad()
    def sync_to_model(self):
        """Every block's current weights on every rank (each broadcast
        from the stage that holds it), so the whole model can evaluate."""
        if self.n_stages == 1 or self._pp is None:
            return
        state = self.model.state_dict(keep_vars=True)
        lps = self.layers_per_stage
        for i in sorted(self._layer_names):
            owner = i // lps
            for k in sorted(self._layer_names[i].values()):
                t = state[k]
                if t.numel() == 0:
                    t.data = torch.empty(self._full_shapes[k],
                                         dtype=t.dtype, device=t.device)
                dist.broadcast(t.data, src=dist.get_global_rank(self._pp,
                                                                owner),
                               group=self._pp)


def gpt_pipeline_step(model, optimizer, mesh, n_micro=4, remat=True,
                      schedule="gpipe"):
    """A ``PipelinedTrainStep`` over a ``models.GPTForPretraining``: the
    reference's embedding (word + position, embedding dropout) and head
    (final LayerNorm, logits by the tied embedding in f32, the mean
    negative log-likelihood)."""
    cfg = model.gpt.config

    def embed_fn(rest, ids_m):
        n_micro, mb, s = ids_m.shape
        flat = ids_m.reshape(n_micro * mb, s).long()
        pos = torch.arange(s, device=flat.device)
        h = (rest["gpt.word_embeddings.weight"][flat]
             + rest["gpt.position_embeddings.weight"][pos][None])
        p = cfg.hidden_dropout_prob
        if p > 0.0:
            keep = torch.rand(h.shape, device=h.device,
                              generator=rng.current_generator(h.device)
                              ) >= p
            h = torch.where(keep, h / (1.0 - p), torch.zeros_like(h))
        return h.reshape(n_micro, mb, s, -1)

    def head_loss_fn(rest, h, labels):
        g, b = rest["gpt.ln_f.weight"], rest["gpt.ln_f.bias"]
        mu = h.mean(-1, keepdim=True)
        var = ((h - mu) ** 2).mean(-1, keepdim=True)
        h = (h - mu) / torch.sqrt(var + 1e-5) * g + b
        logits = torch.matmul(h, rest["gpt.word_embeddings.weight"].t()
                              ).float()
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
        return -ll.mean()

    return PipelinedTrainStep(
        model, optimizer, mesh, block_re=r"gpt\.blocks\.(\d+)\.(.*)",
        block_module=model.gpt.blocks[0], embed_fn=embed_fn,
        head_loss_fn=head_loss_fn, n_micro=n_micro, remat=remat,
        schedule=schedule)
