"""Host-RAM embedding tables bigger than the card (counterpart of
paddle_tpu/embedding/host_table.py).

The table's rows and its row-wise optimizer moments live in host RAM as
numpy arrays; only one batch's working slab (its deduped rows and their
moments) is on the device.  ``HostPrefetchPipeline`` pulls the next
batch's rows on a worker thread while the current step runs (depth-1
double buffering) into pinned staging buffers, patches the rows the
in-flight batch just wrote back, and copies the slab up on a side stream
whose event the step waits on; ``complete`` copies the updated slab back
and queues its scatter into the table on the worker, behind the fetch
already queued.  ``HostTableTrainStep`` is one ``jit.TrainStep`` over the
model's dense parameters and the slab (a parameter of the step's own
wrapper, updated by the same optimizer arithmetic), captured as a CUDA
graph per batch signature on the card.

Contract (tests/test_torch_embedding.py): the async pipeline is
bit-identical to a synchronous one (the next fetch is queued before the
scatter, and the overlap with the pending write is re-patched from the
write's own buffers); a poisoned fetched copy (the ``row_corrupt`` fault)
is found by the fetch-side finiteness check and fetched again from the
table; a checkpoint carries rows, moments, the dense state and the data
cursor, and resuming from it is bit-exact.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..nn.layer_base import Layer

__all__ = ["HostEmbeddingTable", "PreparedBatch", "HostPrefetchPipeline",
           "HostTableTrainStep"]

_obs_handles = None


def _obs():
    """(prefetch wait histogram, device table bytes gauge), made once."""
    global _obs_handles
    if _obs_handles is None:
        from ..observability import metrics as _m
        _obs_handles = (
            _m.histogram("embedding_prefetch_wait_seconds",
                         "time the train loop waited for the next batch's "
                         "host-table row slab (0 ~= the prefetch fully "
                         "overlapped the step)"),
            _m.gauge("embedding_device_table_bytes",
                     "bytes of host-table rows + moments resident on "
                     "device for the current step (the working set, not "
                     "the table)"))
    return _obs_handles


class HostEmbeddingTable:
    """A (num_embeddings, embedding_dim) table in host RAM with row-wise
    optimizer-moment slabs beside it; only touched through deduped row
    gathers and scatters.  ``rows=`` adopts an existing array (no draw)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 dtype="float32", init_scale: float = 0.01, seed: int = 0,
                 name: str = "host_table",
                 rows: Optional[np.ndarray] = None):
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.dtype = np.dtype(dtype)
        self.name = name
        if rows is not None:
            rows = np.asarray(rows, self.dtype)
            if rows.shape != (self.num_embeddings, self.embedding_dim):
                raise ValueError(
                    f"HostEmbeddingTable: rows shape {rows.shape} != "
                    f"({self.num_embeddings}, {self.embedding_dim})")
            self.rows = rows
        else:
            rng = np.random.RandomState(seed)
            self.rows = (rng.standard_normal(
                (num_embeddings, embedding_dim))
                * init_scale).astype(self.dtype)
        self.opt_slabs: Dict[str, np.ndarray] = {}

    @property
    def nbytes(self) -> int:
        return self.rows.nbytes + sum(s.nbytes for s in
                                      self.opt_slabs.values())

    def ensure_opt_state(self, optimizer):
        """The row-wise moment slabs of ``optimizer`` (idempotent); a
        state leaf that is not row-wise is refused."""
        if self.opt_slabs:
            return
        template = optimizer.init_state(
            torch.zeros((1, self.embedding_dim),
                        dtype=torch.from_numpy(self.rows[:0]).dtype))
        for k, leaf in template.items():
            if tuple(leaf.shape) != (1, self.embedding_dim):
                raise NotImplementedError(
                    f"HostEmbeddingTable: optimizer state leaf {k!r} is "
                    f"not row-wise (shape {tuple(leaf.shape)}); host "
                    "tables support row-wise-state optimizers (SGD/"
                    "Momentum/Adam family)")
            # written once now: a lazily mapped zero page would cost a
            # page fault per scattered row on the hot path
            slab = np.empty((self.num_embeddings, self.embedding_dim),
                            leaf.numpy().dtype)
            slab.fill(0)
            self.opt_slabs[k] = slab

    def gather(self, uids: np.ndarray, cap: int, out=None
               ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Rows and moments of ``uids`` in (cap, D) slabs (the slots past
        len(uids) zero); ``out`` gives the slabs to fill."""
        u = len(uids)
        if out is None:
            out = (np.empty((cap, self.embedding_dim), self.dtype),
                   {k: np.empty((cap, self.embedding_dim), s.dtype)
                    for k, s in self.opt_slabs.items()})
        slab, states = out
        np.take(self.rows, uids, axis=0, out=slab[:u])
        slab[u:] = 0
        for k, s in self.opt_slabs.items():
            np.take(s, uids, axis=0, out=states[k][:u])
            states[k][u:] = 0
        return slab, states

    def scatter(self, uids: np.ndarray, slab: np.ndarray,
                states: Dict[str, np.ndarray]):
        """Write rows and moments back (the first len(uids) slots)."""
        u = len(uids)
        self.rows[uids] = np.asarray(slab[:u], self.dtype)
        for k, s in states.items():
            self.opt_slabs[k][uids] = np.asarray(s[:u],
                                                 self.opt_slabs[k].dtype)

    def state_tree(self) -> dict:
        return {"rows": torch.from_numpy(self.rows),
                "opt": {k: torch.from_numpy(v)
                        for k, v in self.opt_slabs.items()}}

    def load_state_tree(self, tree: dict):
        self.rows = np.array(np.asarray(tree["rows"]), self.dtype)
        self.opt_slabs = {k: np.array(np.asarray(v)) for k, v in
                          tree.get("opt", {}).items()}


class PreparedBatch:
    """One batch's working set: host arrays until ``next_prepared`` puts
    the slab on the device (``slab``, ``states``, ``inv`` become device
    tensors and ``event`` the upload's)."""

    __slots__ = ("index", "inputs", "label", "uids", "inv", "n_unique",
                 "cap", "slab", "states", "waited_s", "was_hit", "event")

    def __init__(self, index, inputs, label, uids, inv, cap, slab, states):
        self.index = index
        self.inputs = inputs
        self.label = label
        self.uids = uids
        self.inv = inv
        self.n_unique = len(uids)
        self.cap = cap
        self.slab = slab
        self.states = states
        self.waited_s = 0.0
        self.was_hit = False
        self.event = None


def _round_bucket(n: int, bucket: int) -> int:
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


class HostPrefetchPipeline:
    """Depth-1 double-buffered row prefetch over a deterministic batch
    stream.  ``batch_fn(i)`` returns batch i as (inputs..., ids, label)
    numpy arrays, ids (B, F); ``offsets`` maps per-feature ids into the
    table.  The slab's cap rounds up to ``bucket`` and never shrinks, so
    the step's signature does not flap.  ``device`` is where the slabs go
    (default the card)."""

    def __init__(self, table: HostEmbeddingTable,
                 batch_fn: Callable[[int], tuple], n_batches: int,
                 optimizer=None, offsets: Optional[np.ndarray] = None,
                 async_prefetch: bool = True, bucket: int = 1024,
                 start_index: int = 0, *, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.table = table
        self.batch_fn = batch_fn
        self.n_batches = int(n_batches)
        self.offsets = (None if offsets is None
                        else np.asarray(offsets, np.int64))
        self.async_prefetch = bool(async_prefetch)
        self.bucket = int(bucket)
        self._cap_high_water = 0
        self._next = int(start_index)
        self._outstanding: Optional[PreparedBatch] = None
        # (uids, rows, states) of the newest write-back: the overlap patch
        # reads these, never the table the worker may be writing
        self._pending_write = None
        self._write_future = None
        self._future = None
        self._fetch_no = 0
        self.hits = 0
        self.misses = 0
        self.corrupt_refetches = 0
        self.wait_seconds = 0.0
        self.peak_device_table_bytes = 0
        # two pinned staging sets (depth 1: one being filled while the
        # other's batch runs), reallocated when the cap grows
        self._staging = [None, None]
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        if optimizer is not None:
            table.ensure_opt_state(optimizer)
        self._executor = None
        if self.async_prefetch:
            from concurrent.futures import ThreadPoolExecutor
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pdtpu-emb-prefetch")
            if self._next < self.n_batches:
                self._future = self._executor.submit(self._prepare,
                                                     self._next)

    # -- worker --------------------------------------------------------------
    def _buffers(self, which: int, cap: int):
        """Staging set ``which`` of at least ``cap`` rows (pinned on a
        card): (slab, {leaf: moments}) numpy views of ``cap`` rows."""
        cur = self._staging[which]
        d = self.table.embedding_dim
        if cur is None or cur[0].shape[0] != cap:
            pin = self.device.type == "cuda"

            def buf(dtype):
                t = torch.empty((cap, d), dtype=torch.from_numpy(
                    np.empty(0, dtype)).dtype, pin_memory=pin)
                return t.numpy()
            cur = (buf(self.table.dtype),
                   {k: buf(s.dtype) for k, s in
                    self.table.opt_slabs.items()})
            self._staging[which] = cur
        return cur

    def _prepare(self, i: int) -> PreparedBatch:
        from ..utils import faults as _faults
        from ..utils.monitor import stat_add
        self._fetch_no += 1
        fetch_no = self._fetch_no
        _faults.maybe_stall_prefetch(fetch_no - 1)
        *inputs, ids, label = self.batch_fn(i)
        ids = np.asarray(ids)
        flat = ids.reshape(-1).astype(np.int64)
        if self.offsets is not None:
            flat = (ids.astype(np.int64)
                    + self.offsets.reshape(1, -1)).reshape(-1)
        uids, inv = np.unique(flat, return_inverse=True)
        cap = max(_round_bucket(len(uids), self.bucket),
                  self._cap_high_water)
        self._cap_high_water = cap
        which = fetch_no % 2
        slab, states = self.table.gather(uids, cap,
                                         self._buffers(which, cap))
        stat_add("STAT_embedding_rows_gathered", int(flat.size))
        stat_add("STAT_embedding_rows_unique", int(len(uids)))
        stat_add("STAT_embedding_host_to_device_bytes",
                 int(slab.nbytes + sum(s.nbytes for s in states.values())))
        if _faults.row_corrupt_fetch() == fetch_no and len(uids):
            # poison the fetched copy (never the table): a torn transfer
            slab[0] = np.nan
        # the torn-transfer check, on the worker so it overlaps the step:
        # a poisoned copy is fetched again from the table
        if len(uids) and not np.isfinite(slab[:len(uids)]).all():
            stat_add("STAT_embedding_corrupt_rows_detected")
            self.corrupt_refetches += 1
            slab[:len(uids)] = self.table.rows[uids]
        return PreparedBatch(i, tuple(np.asarray(a) for a in inputs),
                             np.asarray(label), uids,
                             inv.reshape(-1).astype(np.int64), cap, slab,
                             states)

    # -- consumer ------------------------------------------------------------
    def __len__(self):
        return max(0, self.n_batches - self._next)

    def _upload(self, prep: PreparedBatch):
        """The patched host slab to the device: on a card a side stream's
        non-blocking copies from the pinned staging buffers, recorded as
        ``prep.event`` (the step waits on it)."""
        dev = self.device
        host = [prep.slab] + list(prep.states.values()) + [prep.inv]
        if self._stream is None:
            outs = [torch.from_numpy(np.array(a)) for a in host]
        else:
            inv = torch.from_numpy(prep.inv).pin_memory()
            srcs = [torch.from_numpy(a) for a in host[:-1]] + [inv]
            with torch.cuda.stream(self._stream):
                outs = [s.to(dev, non_blocking=True) for s in srcs]
                prep.event = torch.cuda.Event()
                prep.event.record(self._stream)
            for o in outs:   # freed only after the side stream's copy
                o.record_stream(self._stream)
        prep.slab = outs[0]
        prep.states = dict(zip(prep.states, outs[1:-1]))
        prep.inv = outs[-1]

    def next_prepared(self) -> Optional[PreparedBatch]:
        """The next batch's working set on the device (None when the
        stream is exhausted).  The previous batch must be ``complete``d
        first: that is what makes the overlap patch exact."""
        from ..utils.monitor import stat_add
        if self._outstanding is not None:
            raise RuntimeError(
                "HostPrefetchPipeline: complete() the previous batch "
                "before requesting the next one")
        if self._next >= self.n_batches:
            return None
        i = self._next
        # queue the NEXT fetch first, so the worker takes it the moment it
        # is free (behind any queued scatter)
        next_future = None
        if self._executor is not None and i + 1 < self.n_batches:
            next_future = self._executor.submit(self._prepare, i + 1)
        wait_h, bytes_g = _obs()
        t0 = time.perf_counter()
        if self._future is not None:
            hit = self._future.done()
            prep = self._future.result()
            self._future = None
        else:
            hit = False
            prep = self._prepare(i)
        prep.waited_s = time.perf_counter() - t0
        prep.was_hit = hit
        self.wait_seconds += prep.waited_s
        wait_h.observe(prep.waited_s)
        if hit:
            self.hits += 1
            stat_add("STAT_embedding_prefetch_hits")
        else:
            self.misses += 1
            stat_add("STAT_embedding_prefetch_misses")
        # the overlap with the pending write-back was stale when fetched:
        # take those rows from the write's own buffers
        if self._pending_write is not None and prep.n_unique:
            w_uids, w_rows, w_states = self._pending_write
            overlap = np.intersect1d(prep.uids, w_uids, assume_unique=True)
            if overlap.size:
                slots = np.searchsorted(prep.uids, overlap)
                src = np.searchsorted(w_uids, overlap)
                prep.slab[slots] = w_rows[src]
                for k, s in prep.states.items():
                    s[slots] = w_states[k][src]
        self._upload(prep)
        resident = int(sum(t.numel() * t.element_size() for t in
                           [prep.slab] + list(prep.states.values())))
        self.peak_device_table_bytes = max(self.peak_device_table_bytes,
                                           resident)
        bytes_g.set(resident)
        self._next = i + 1
        self._outstanding = prep
        self._future = next_future
        return prep

    def complete(self, prep: PreparedBatch, new_slab, new_states: dict):
        """Copy batch ``prep``'s updated rows and moments back and queue
        their scatter into the table on the worker, after the fetch
        already queued (which thus reads the table before the write; the
        overlap patch supplies the new values)."""
        from ..utils.monitor import stat_add
        if self._outstanding is not prep:
            raise RuntimeError("HostPrefetchPipeline: complete() got a "
                               "batch that is not the outstanding one")
        u = prep.n_unique
        rows = new_slab[:u].detach().cpu().numpy().copy()
        states = {k: v[:u].detach().cpu().numpy().copy()
                  for k, v in new_states.items()}
        stat_add("STAT_embedding_device_to_host_bytes",
                 int(rows.nbytes + sum(s.nbytes for s in states.values())))
        self._pending_write = (prep.uids, rows, states)
        if self._executor is not None:
            self._write_future = self._executor.submit(
                self.table.scatter, prep.uids, rows, states)
        else:
            self.table.scatter(prep.uids, rows, states)
        self._outstanding = None

    def flush(self):
        """Wait until every queued table write has landed."""
        if self._write_future is not None:
            self._write_future.result()
            self._write_future = None

    def cursor(self) -> dict:
        """The checkpoint cursor (the next batch index); refused while a
        batch is outstanding (its rows are not in the table yet)."""
        if self._outstanding is not None:
            raise RuntimeError(
                "HostPrefetchPipeline: cannot checkpoint with batch "
                f"{self._outstanding.index} outstanding — complete() it "
                "first so its row updates are in the table the snapshot "
                "captures")
        return {"batch_index": self._next}

    def metrics(self) -> dict:
        total = self.hits + self.misses
        return {"fetches": total, "hits": self.hits, "misses": self.misses,
                "hit_rate": (self.hits / total) if total else None,
                "wait_seconds": self.wait_seconds,
                "corrupt_refetches": self.corrupt_refetches,
                "peak_device_table_bytes": self.peak_device_table_bytes}

    def close(self):
        if self._executor is not None:
            self.flush()
            self._executor.shutdown(wait=True)
            self._executor = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _SlabModel(Layer):
    """The step's model: the dense model ``m`` fed the slab's rows.
    ``forward(*inputs, inv, shape, label-less)``: ``shape`` is a
    (cap, B, F, 0) tensor that carries the slab's cap and the ids' shape
    into the batch signature."""

    def __init__(self, model, table: HostEmbeddingTable, device):
        super().__init__()
        self.m = model
        self.table_name = table.name
        setattr(self, table.name, torch.nn.Parameter(torch.zeros(
            (0, table.embedding_dim), dtype=torch.from_numpy(
                table.rows[:0]).dtype, device=device)))

    def slab(self):
        return getattr(self, self.table_name)

    def forward(self, *args):
        *inputs, inv, shape = args
        _, b, f, _ = shape.shape
        emb = self.slab()[inv].reshape(b, f, self.slab().shape[1])
        return self.m(*inputs, emb)


class HostTableTrainStep:
    """One training step over the dense model's parameters and the
    current batch's slab (module docstring).  ``model`` runs in
    external-embedding mode: ``forward(*inputs, emb)`` with emb the
    gathered (B, F, D) rows."""

    def __init__(self, model: Layer, loss_fn, optimizer,
                 table: HostEmbeddingTable):
        from ..jit import TrainStep
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.table = table
        table.ensure_opt_state(optimizer)
        dev = next(iter(model.state_dict().values())).device
        self._wrap = _SlabModel(model, table, dev)
        self._key = table.name
        self._ts = TrainStep(self._wrap, loss_fn, optimizer)

    def _fit(self, cap: int):
        """The slab parameter and its moments at ``cap`` rows (made anew
        when the cap grows: a new signature, a new program)."""
        ts, p = self._ts, self._wrap.slab()
        if ts._opt_state is None:
            state = {k: v.detach() for k, v in
                     self._wrap.state_dict(keep_vars=True).items()}
            ts._opt_state = ts.init_opt_state(state)
        if p.shape[0] != cap:
            p.data = torch.zeros((cap, p.shape[1]), dtype=p.dtype,
                                 device=p.device)
            ts._opt_state[self._key] = self.optimizer.init_state(p.detach())

    def run(self, prep: PreparedBatch, ids_shape):
        """One step on a prepared batch: (loss, new slab, new slab
        moments), the latter two for ``pipeline.complete``."""
        b, f = ids_shape
        self._fit(prep.cap)
        slab = self._wrap.slab()
        dev = slab.device
        if prep.event is not None:
            torch.cuda.current_stream(dev).wait_event(prep.event)
        moments = self._ts._opt_state[self._key]
        with torch.no_grad():
            slab.copy_(prep.slab)
            for k, v in prep.states.items():
                moments[k].copy_(v)
        shape = torch.empty((prep.cap, b, f, 0), device=dev)
        batch = tuple(torch.as_tensor(a, device=dev) for a in prep.inputs)
        batch = batch + (prep.inv.to(dev), shape,
                         torch.as_tensor(prep.label, device=dev))
        loss = self._ts(*batch)
        return loss, slab.detach(), dict(moments)

    def compile_counts(self) -> dict:
        return self._ts.compile_counts()

    # -- checkpoints (rows + moments + dense state + cursor) -----------------
    def _dense_opt(self):
        ts = self._ts
        if ts._opt_state is None:
            self._fit(0)
        return {k[2:]: v for k, v in ts._opt_state.items()
                if k != self._key}

    def save_checkpoint(self, directory: str,
                        pipeline: Optional[HostPrefetchPipeline] = None,
                        step: Optional[int] = None,
                        extra_meta: Optional[dict] = None) -> str:
        from ..distributed import checkpoint as dck
        from ..jit import state_arrays
        from ..utils.monitor import stat_add
        stat_add("STAT_checkpoint_saves")
        if pipeline is not None:
            pipeline.flush()   # the table, not the pending buffers
        extra = dck.train_state_extras(
            self.optimizer, extra_meta, None,
            pipeline.cursor() if pipeline is not None else None)
        tree = {"params": state_arrays(self.model),
                "opt": self._dense_opt(),
                "table": self.table.state_tree()}
        return dck.save_sharded(
            tree, directory,
            step if step is not None else self.optimizer._step_count, extra)

    @torch.no_grad()
    def restore_checkpoint(self, directory: str) -> Optional[dict]:
        from ..distributed import checkpoint as dck
        res = dck.restore_sharded(directory)
        if res is None:
            return None
        tree, step, extra = res
        sd = self.model.state_dict(keep_vars=True)
        for k, v in tree.get("params", {}).items():
            sd[k].copy_(v.to(sd[k].dtype))
        opt = self._dense_opt()
        for k, slots in tree.get("opt", {}).items():
            for s, v in slots.items():
                if k in opt and s in opt[k]:
                    opt[k][s].copy_(v.to(opt[k][s].dtype))
        meta = dck.restore_train_extras(self.optimizer, step, extra)
        self.table.load_state_tree(tree.get("table", {}))
        return meta
