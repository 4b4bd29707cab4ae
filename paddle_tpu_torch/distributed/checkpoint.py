"""Training checkpoints in the reference's on-disk layout (counterpart of
paddle_tpu/distributed/checkpoint.py).

Layout of a checkpoint directory, as the reference writes it:

    step-000000042/
        manifest.json      {"step", "arrays": {name: {"shape", "dtype",
                           "spec"}}, "extra", "n_processes"}
        shards-p00000.npz  the arrays, one entry per shard, keyed
                           "name@start0,start1,..."
    latest                 names the newest complete step directory

Names are the flattened tree's paths (``params/bert.pooler.dense.weight``,
``opt/<name>/moment1``).  A save writes the npz and the manifest into a
temporary directory, syncs them, renames it into place, syncs the parent
and only then rewrites ``latest``, so a kill mid-save leaves the previous
checkpoint restorable; ``latest_step_dir`` falls back to the newest step
directory with a readable manifest.

Arrays cross as host numpy arrays.  bfloat16, which numpy lacks, is
written as numpy writes an ml_dtypes ``bfloat16`` array (2-byte void
entries holding the bf16 words, the same bytes as the reference's npz)
with the manifest's dtype ``"bfloat16"``, and read back as its 16-bit
words into a torch bfloat16 tensor.  ``restore_sharded`` returns CPU
tensors; it assembles an array from whichever shards the files hold.

``AsyncCheckpointManager`` takes the snapshot on the caller (CUDA tensors
into pinned host memory, one synchronisation for the whole tree) and
hands it to one writer thread that serialises, publishes, syncs and
prunes; ``train_epoch_range`` resumes an epoch loop after the newest
checkpoint's epoch.  The ``kill_mid_save`` fault (``utils.faults``) fires
between a save's files and the rename that publishes them.

**Several processes.** A leaf of the tree may be a ``Shard``: a rank's
block of a larger array (its data, the whole array's shape, the block's
index, the spec, and whether this rank owns the block).  In a started
``torch.distributed`` world each rank writes the blocks it owns into
``shards-p{rank}.npz`` (a whole tensor is written once, by rank 0), the
ranks meet at a barrier, and rank 0 removes stale files of an earlier
save with more processes, then publishes the manifest (the whole shapes
and the specs, ``n_processes`` the world size) and ``latest``; a second
barrier returns every rank after the publish.  ``restore_sharded(mesh=,
shardings=)`` gives each rank its block of every array (``shardings``
a nested dict of ``parallel.NamedSharding`` by name, else the saved spec
on ``mesh``'s axes), assembled from whichever files hold it: a checkpoint
restores onto another topology, the reference's included, and the
reference reads the port's.  ``AsyncCheckpointManager`` stays
single-process.

The non-array training state rides in the manifest's ``extra`` under the
reference's keys (``__lr_sched__``, ``__data_cursor__``, a GradScaler's
``__scaler__``), except the
random stream: the reference saves its threefry key as ``__rng__``, which
means nothing to torch generators.  The port saves its seed stream and the
training step's generator under ``__torch_rng__`` instead, and leaves a
reference checkpoint's ``__rng__`` unused.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import tempfile
import threading
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..core import rng as _rng
from ..core.errors import (ExecutionTimeoutError, InvalidArgumentError,
                           UnimplementedError)
from ..utils.monitor import stat_add

__all__ = ["Shard", "snapshot_tree", "publish_snapshot", "save_sharded",
           "latest_step_dir", "restore_sharded", "train_state_extras",
           "save_train_state", "restore_train_extras", "apply_train_state",
           "merge_opt_state", "CheckpointManager", "AsyncCheckpointManager",
           "train_epoch_range"]

_STEP_DIR_RE = re.compile(r"^step-(\d+)$")
RNG_KEY = "__torch_rng__"
_BF16_WORDS = np.dtype("V2")   # how numpy stores an ml_dtypes bfloat16

_obs_handles = None


def _obs():
    """(save_stall_histogram, async_in_flight_gauge) — observability
    handles, created once (registry.reset() zeroes in place)."""
    global _obs_handles
    if _obs_handles is None:
        from ..observability import metrics as _m
        _obs_handles = (
            _m.histogram("checkpoint_save_stall_seconds",
                         "wall time the training thread was stalled by a "
                         "checkpoint save (sync: full write; async: "
                         "snapshot + enqueue)"),
            _m.gauge("checkpoint_async_in_flight",
                     "snapshots queued or being written by the async "
                     "checkpoint writer"))
    return _obs_handles


def _index_key(name: str, index) -> str:
    starts = ",".join(str(0 if s.start is None else int(s.start))
                      for s in index)
    return f"{name}@{starts}"


# -- tree flattening (params + nested opt-state dicts) ----------------------

def _flatten(tree, prefix="", out=None):
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}{k}/", out)
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, object]):
    tree: Dict[str, object] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


class Shard(NamedTuple):
    """A rank's block of a larger array, as a leaf of a saved tree."""
    data: torch.Tensor
    shape: tuple          # the whole array's
    index: tuple          # the block, as slices
    spec: list            # the PartitionSpec's entries
    owner: bool           # whether this rank writes the block


def _world():
    """(rank, world size) of the started process group, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _single_process():
    if _world()[1] > 1:
        raise UnimplementedError(
            "AsyncCheckpointManager writes from one process; save a "
            "several-process checkpoint with save_sharded")


def _spec_json(spec) -> list:
    return [list(e) if isinstance(e, (tuple, list)) else e for e in spec]


# -- host arrays ------------------------------------------------------------

def _host_array(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy; bf16 as numpy writes ml_dtypes'
    bfloat16 (its words in 2-byte voids)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_WORDS).copy()
    return t.numpy().copy()


def _numpy_of(t: torch.Tensor) -> np.ndarray:
    """``t`` (a host tensor the caller owns) as numpy, sharing its memory;
    bf16 as its words in 2-byte voids."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_WORDS)
    return t.numpy()


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A CPU tensor of a restored array whose manifest dtype is ``dtype``."""
    if dtype == "bfloat16":
        words = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype)))


# -- save -------------------------------------------------------------------

def _pinned_copies(flat: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Host copies of the tree's tensors: CUDA tensors into pinned host
    buffers by asynchronous copies, then one synchronisation for all of
    them (the copies run at the link's rate, not a pageable copy's, and the
    caching host allocator keeps the buffers for the next snapshot); host
    tensors are cloned."""
    out, pending = {}, False
    for name, t in flat.items():
        t = t.detach()
        if t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            pending = True
        else:
            buf = t.clone()
        out[name] = buf
    if pending:
        torch.cuda.synchronize()
    return {name: _numpy_of(buf) for name, buf in out.items()}


def snapshot_tree(state_tree, step: int = 0,
                  extra_meta: Optional[dict] = None, *, pinned: bool = False):
    """Copy every tensor of the tree to host memory and build the manifest.
    Returns (manifest, shards).  Each array is one shard (a whole array,
    spec ``[]``, replicated), as the reference's unsharded save.  With
    ``pinned`` the copies go through pinned host buffers
    (``_pinned_copies``), as the asynchronous manager takes them."""
    flat = _flatten(state_tree)
    rank, world = _world()
    manifest = {"step": int(step), "arrays": {}, "extra": extra_meta or {},
                "n_processes": world}
    shards = {}
    for name, t in list(flat.items()):
        if isinstance(t, Shard):
            manifest["arrays"][name] = {
                "shape": list(t.shape),
                "dtype": str(t.data.dtype).replace("torch.", ""),
                "spec": _spec_json(t.spec)}
            if t.owner:
                shards[_index_key(name, t.index)] = _host_array(t.data)
            del flat[name]
        elif rank != 0:   # a whole array is written once, by rank 0
            manifest["arrays"][name] = {
                "shape": list(t.shape),
                "dtype": str(t.dtype).replace("torch.", ""), "spec": []}
            del flat[name]
    hosts = _pinned_copies(flat) if pinned else {}
    for name, t in flat.items():
        arr = hosts[name] if pinned else _host_array(t)
        manifest["arrays"][name] = {
            "shape": list(arr.shape),
            "dtype": str(t.dtype).replace("torch.", ""), "spec": []}
        shards[_index_key(name, (slice(None),) * arr.ndim)] = arr
    return manifest, shards


def _fsync_dir(path: str):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_atomic(path: str, content: str):
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
    with os.fdopen(fd, "w") as f:
        f.write(content)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def publish_snapshot(directory: str, manifest: dict, shards: dict) -> str:
    """Write the npz and the manifest into a temporary directory, sync
    them, rename it into place, sync the parent, then point ``latest`` at
    it, inside a ``checkpoint_publish`` span.  Returns the step
    directory."""
    from ..observability import span as _span
    with _span("checkpoint_publish", args={"step": manifest["step"]}):
        stat_add("STAT_checkpoint_bytes_written",
                 sum(a.nbytes for a in shards.values()))
        return _publish_snapshot_inner(directory, manifest, shards)


def _publish_snapshot_inner(directory: str, manifest: dict,
                            shards: dict) -> str:
    step_dir = os.path.join(directory, f"step-{manifest['step']:09d}")
    tmp_dir = step_dir + ".tmp-p00000"
    os.makedirs(tmp_dir, exist_ok=True)
    with open(os.path.join(tmp_dir, "shards-p00000.npz"), "wb") as f:
        np.savez(f, **shards)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    # fault point: a kill here (files written, not yet renamed) must leave
    # the previous checkpoint restorable
    from ..utils import faults as _faults
    _faults.maybe_kill_mid_save()
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    _fsync_dir(directory)
    _write_atomic(os.path.join(directory, "latest"),
                  os.path.basename(step_dir))
    return step_dir


def save_sharded(state_tree, directory: str, step: int = 0,
                 extra_meta: Optional[dict] = None) -> str:
    """Write a checkpoint of a tree (nested dicts) of tensors and
    ``Shard``s; from several processes each writes its own blocks (module
    docstring).  The whole save is observed as
    ``checkpoint_save_stall_seconds``.  Returns the step directory."""
    os.makedirs(directory, exist_ok=True)
    stall_h, _ = _obs()
    with stall_h.time():
        manifest, shards = snapshot_tree(state_tree, step, extra_meta)
        rank, world = _world()
        if world == 1:
            return publish_snapshot(directory, manifest, shards)
        return _publish_multi(directory, manifest, shards, rank, world)


def _publish_multi(directory: str, manifest: dict, shards: dict, rank: int,
                   world: int) -> str:
    """Each rank lands its npz in the step directory; after a barrier rank
    0 publishes the manifest and ``latest``; a second barrier."""
    dist = torch.distributed
    stat_add("STAT_checkpoint_bytes_written",
             sum(a.nbytes for a in shards.values()))
    step_dir = os.path.join(directory, f"step-{manifest['step']:09d}")
    tmp_dir = step_dir + f".tmp-p{rank:05d}"
    os.makedirs(tmp_dir, exist_ok=True)
    npz = f"shards-p{rank:05d}.npz"
    with open(os.path.join(tmp_dir, npz), "wb") as f:
        np.savez(f, **shards)
        f.flush()
        os.fsync(f.fileno())
    os.makedirs(step_dir, exist_ok=True)
    os.replace(os.path.join(tmp_dir, npz), os.path.join(step_dir, npz))
    shutil.rmtree(tmp_dir, ignore_errors=True)
    dist.barrier()
    if rank == 0:
        for f in os.listdir(step_dir):
            if (f.startswith("shards-p") and f.endswith(".npz")
                    and int(f[len("shards-p"):-len(".npz")]) >= world):
                os.unlink(os.path.join(step_dir, f))
        _write_atomic(os.path.join(step_dir, "manifest.json"),
                      json.dumps(manifest))
        _fsync_dir(step_dir)
        _write_atomic(os.path.join(directory, "latest"),
                      os.path.basename(step_dir))
    dist.barrier()
    return step_dir


# -- restore ----------------------------------------------------------------

def _shard_files(step_dir: str, n_processes: Optional[int]):
    """The step directory's shard files, those of process N <
    ``n_processes`` only (a re-save from fewer processes leaves stale
    higher-numbered files behind)."""
    names = [f for f in sorted(os.listdir(step_dir))
             if f.startswith("shards-p") and f.endswith(".npz")]
    if n_processes is not None:
        names = [f for f in names
                 if int(f[len("shards-p"):-len(".npz")]) < n_processes]
    return [np.load(os.path.join(step_dir, f)) for f in names]


def _assemble(files, name: str, shape) -> np.ndarray:
    """The whole array ``name`` from every shard the files hold."""
    prefix = f"{name}@"
    full, covered = None, np.zeros(shape, bool)
    for f in files:
        for key in f.files:
            if not key.startswith(prefix):
                continue
            data = f[key]
            if full is None:
                full = np.zeros(shape, data.dtype)
            rest = key[len(prefix):]
            starts = [int(x) for x in rest.split(",")] if rest else []
            idx = tuple(slice(s, s + d) for s, d in zip(starts, data.shape))
            full[idx] = data
            covered[idx] = True
    if full is None or not covered.all():
        missing = covered.size - int(covered.sum())
        raise ValueError(
            f"checkpoint is incomplete for '{name}': {missing} of "
            f"{covered.size} elements have no shard (lost/partial "
            "shard file?)")
    return full


def _has_valid_manifest(step_dir: str) -> bool:
    try:
        with open(os.path.join(step_dir, "manifest.json")) as f:
            json.load(f)
        return True
    except (OSError, ValueError):
        return False


def latest_step_dir(directory: str) -> Optional[str]:
    """The newest restorable step directory: the one ``latest`` names when
    its manifest loads, else the newest ``step-*`` with a loadable
    manifest, else None."""
    try:
        with open(os.path.join(directory, "latest")) as f:
            name = f.read().strip()
    except OSError:
        name = None
    if name:
        step_dir = os.path.join(directory, name)
        if os.path.isdir(step_dir) and _has_valid_manifest(step_dir):
            return step_dir
    try:
        entries = os.listdir(directory)
    except OSError:
        return None
    steps = sorted((int(m.group(1)), d) for d in entries
                   if (m := _STEP_DIR_RE.match(d)))
    for _, d in reversed(steps):
        step_dir = os.path.join(directory, d)
        if os.path.isdir(step_dir) and _has_valid_manifest(step_dir):
            return step_dir
    return None


def _block_of(name: str, meta: dict, mesh, flat_shardings):
    """The slices of this rank's block of ``name`` (None: the whole)."""
    from ..parallel.mesh import NamedSharding, P
    sh = flat_shardings.get(name)
    if sh is None and mesh is not None:
        # the saved spec on the axes this mesh has
        def known(e):
            return e is None or all(a in mesh.shape for a in (
                e if isinstance(e, tuple) else (e,)))
        entries = [tuple(e) if isinstance(e, list) else e
                   for e in meta.get("spec", [])]
        sh = NamedSharding(mesh, P(*[e if known(e) else None
                                     for e in entries]))
    return None if sh is None else sh.index(tuple(meta["shape"]))


def restore_sharded(directory: str, mesh=None, shardings=None,
                    step: Optional[int] = None):
    """(state_tree, step, extra_meta) from a checkpoint directory (the
    newest, or ``step``'s), the arrays as CPU tensors; None when there is
    no checkpoint.  With ``mesh`` / ``shardings`` each array is this
    rank's block (module docstring)."""
    from ..parallel.mesh import Mesh
    if mesh is not None and not isinstance(mesh, Mesh):
        raise InvalidArgumentError(
            f"restore_sharded: mesh must be a parallel.Mesh, got "
            f"{type(mesh).__name__}")
    flat_sh = _flatten(shardings) if shardings else {}
    step_dir = (os.path.join(directory, f"step-{step:09d}")
                if step is not None else latest_step_dir(directory))
    if step_dir is None or not os.path.isdir(step_dir):
        return None
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    files = _shard_files(step_dir, manifest.get("n_processes"))
    out = {}
    for name, meta in manifest["arrays"].items():
        full = _assemble(files, name, tuple(meta["shape"]))
        idx = (_block_of(name, meta, mesh, flat_sh)
               if mesh is not None or flat_sh else None)
        if idx is not None:
            full = np.ascontiguousarray(full[idx])
        out[name] = _to_tensor(full, meta["dtype"])
    return _unflatten(out), manifest["step"], manifest.get("extra", {})


# -- train-step glue (jit.TrainStep) ----------------------------------------

def _state_list(gen: torch.Generator) -> list:
    return gen.get_state().tolist()


def _state_tensor(values: list) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.uint8)


def train_state_extras(optimizer=None, extra_meta: Optional[dict] = None,
                       scaler=None, data_cursor: Optional[dict] = None,
                       *, generator: Optional[torch.Generator] = None) -> dict:
    """The non-array training state for a checkpoint's extra dict: the
    port's seed stream and the step's ``generator`` (``__torch_rng__``),
    the scheduler's state (``__lr_sched__``), a GradScaler's
    (``__scaler__``) and the data cursor (``__data_cursor__``)."""
    extra = dict(extra_meta or {})
    extra[RNG_KEY] = {
        "stream": _state_list(_rng._stream),
        "step": None if generator is None else _state_list(generator),
        "step_device": None if generator is None else generator.device.type}
    sched = getattr(optimizer, "_lr_scheduler", None)
    if sched is not None:
        extra["__lr_sched__"] = sched.state_dict()
    if scaler is not None:
        extra["__scaler__"] = scaler.state_dict()
    if data_cursor is not None:
        extra["__data_cursor__"] = dict(data_cursor)
    return extra


def save_train_state(directory: str, params, opt_state, step: int,
                     extra_meta: Optional[dict] = None, optimizer=None,
                     scaler=None, data_cursor: Optional[dict] = None,
                     *, generator: Optional[torch.Generator] = None) -> str:
    """Parameters (and buffers), optimizer state and the extras, as the
    reference's ``{"params": ..., "opt": ...}`` tree."""
    stat_add("STAT_checkpoint_saves")
    extra = train_state_extras(optimizer, extra_meta, scaler, data_cursor,
                               generator=generator)
    return save_sharded({"params": params, "opt": opt_state}, directory,
                        step, extra)


def restore_train_extras(optimizer, step: int, extra: dict, scaler=None,
                         *, generator: Optional[torch.Generator] = None
                         ) -> dict:
    """Apply the non-array state of a checkpoint's extra dict: the step
    count, the seed stream and (on a generator of the saved device type)
    the step's generator, the scheduler and ``scaler``'s state.  Pops the
    internal keys (a reference checkpoint's ``__rng__`` is dropped unused)
    and returns the user-facing meta; a saved data cursor comes back as
    ``meta["data_cursor"]``."""
    optimizer._step_count = step
    extra.pop("__rng__", None)
    saved = extra.pop(RNG_KEY, None)
    if saved is not None:
        _rng._stream.set_state(_state_tensor(saved["stream"]))
        if (generator is not None and saved.get("step") is not None
                and saved.get("step_device") == generator.device.type):
            generator.set_state(_state_tensor(saved["step"]))
    sched_state = extra.pop("__lr_sched__", None)
    sched = getattr(optimizer, "_lr_scheduler", None)
    if sched_state is not None and sched is not None:
        sched.set_state_dict(sched_state)
    scaler_state = extra.pop("__scaler__", None)
    if scaler_state is not None and scaler is not None:
        scaler.load_state_dict(scaler_state)
    cursor = extra.pop("__data_cursor__", None)
    if cursor is not None:
        extra["data_cursor"] = cursor
    return {"step": step, **extra}


@torch.no_grad()
def apply_train_state(model, optimizer, restored, scaler=None,
                      *, generator: Optional[torch.Generator] = None):
    """Write a ``restore_sharded`` result into the model's parameters and
    buffers IN PLACE (a captured step reads them by address) and the
    extras into the optimizer, the random stream and ``generator``.
    Returns (meta, the optimizer-state tree)."""
    tree, step, extra = restored
    own = model.state_dict(keep_vars=True)
    for k, v in tree["params"].items():
        if k not in own:
            raise InvalidArgumentError(
                f"checkpoint parameter {k!r} is not in the model")
        dst = own[k].detach()
        if tuple(v.shape) != tuple(dst.shape):
            raise InvalidArgumentError(
                f"checkpoint parameter {k!r} has shape {tuple(v.shape)}, "
                f"the model {tuple(dst.shape)}")
        dst.copy_(v)
    meta = restore_train_extras(optimizer, step, extra, scaler,
                                generator=generator)
    # stateless optimizers save empty per-parameter dicts, which the
    # flatten / unflatten round trip drops: merge_opt_state fills them
    return meta, tree.get("opt", {})


def merge_opt_state(fresh: dict, restored: dict) -> dict:
    """Per parameter: the restored entry wins; a parameter whose state
    vanished in the save keeps the fresh structure."""
    return {k: restored.get(k, fresh[k]) for k in fresh}


# -- checkpoint manager -----------------------------------------------------

class CheckpointManager:
    """Periodic checkpoints with retention: ``save`` every
    ``save_interval_steps`` (or ``save_interval_seconds``), the last
    ``max_to_keep`` kept (and every ``keep_every_k_steps``-th step), and
    ``restore_latest``.  Synchronous: the save runs on the caller."""

    def __init__(self, directory: str, max_to_keep: int = 2,
                 save_interval_steps: int = 100,
                 save_interval_seconds: Optional[float] = None,
                 keep_every_k_steps: Optional[int] = None):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.save_interval_seconds = save_interval_seconds
        self.keep_every_k_steps = keep_every_k_steps
        self._last_saved_step = None
        self._last_saved_time = time.monotonic()
        os.makedirs(directory, exist_ok=True)
        for d in os.listdir(directory):    # debris of a killed save
            if ".tmp-p" in d:
                shutil.rmtree(os.path.join(directory, d), ignore_errors=True)

    def should_save(self, step: int) -> bool:
        if self.save_interval_seconds is not None:
            return (time.monotonic() - self._last_saved_time
                    >= self.save_interval_seconds)
        if self._last_saved_step is None:
            return step >= self.save_interval_steps
        return step - self._last_saved_step >= self.save_interval_steps

    def save(self, state_tree, step: int, extra_meta: Optional[dict] = None):
        path = save_sharded(state_tree, self.directory, step, extra_meta)
        self._last_saved_step = step
        self._last_saved_time = time.monotonic()
        self._prune()
        return path

    def maybe_save(self, state_tree, step: int,
                   extra_meta: Optional[dict] = None):
        if self.should_save(step):
            return self.save(state_tree, step, extra_meta)
        return None

    def restore_latest(self, mesh=None, shardings=None):
        return restore_sharded(self.directory, mesh=mesh,
                               shardings=shardings)

    def all_steps(self):
        return sorted(int(m.group(1)) for d in os.listdir(self.directory)
                      if (m := _STEP_DIR_RE.match(d))
                      and os.path.isdir(os.path.join(self.directory, d)))

    def _prune(self):
        k = self.keep_every_k_steps
        for s in self.all_steps()[:-self.max_to_keep]:
            if k and s % k == 0:
                continue   # a milestone: kept for good
            shutil.rmtree(os.path.join(self.directory, f"step-{s:09d}"),
                          ignore_errors=True)


class AsyncCheckpointManager(CheckpointManager):
    """Checkpoints written off the training thread (one process).

    ``save`` takes only the snapshot on the caller (``snapshot_tree`` with
    pinned host buffers: device to host copies and one synchronisation)
    and hands it to a writer thread, which serialises the npz, renames it
    into place, syncs the directory, moves ``latest`` and prunes.  The
    training thread's stall per save is the snapshot plus the enqueue
    (``checkpoint_save_stall_seconds``).

    - The queue holds at most ``max_in_flight`` snapshots: a writer that
      falls behind blocks the next save instead of buffering more copies
      of the model in host memory.
    - ``wait_until_finished(timeout)`` blocks until every accepted save is
      published (False on timeout).
    - A write running longer than ``watchdog_seconds`` makes the next save
      or wait raise ``ExecutionTimeoutError`` on the training thread.
    - An error on the writer is re-raised on the training thread at the
      next save or wait.
    - ``close()`` flushes, then stops the writer with a bounded join.
    The ``checkpoint_async_in_flight`` gauge holds the snapshots queued or
    being written; ``STAT_checkpoint_async_writes`` counts publishes."""

    def __init__(self, directory: str, max_to_keep: int = 2,
                 save_interval_steps: int = 100,
                 save_interval_seconds: Optional[float] = None,
                 keep_every_k_steps: Optional[int] = None,
                 max_in_flight: int = 1,
                 watchdog_seconds: float = 600.0):
        super().__init__(directory, max_to_keep, save_interval_steps,
                         save_interval_seconds, keep_every_k_steps)
        self._queue: "queue.Queue" = queue.Queue(
            maxsize=max(1, max_in_flight))
        self._watchdog_seconds = watchdog_seconds
        self._cv = threading.Condition()
        self._outstanding = 0
        self._write_started: Optional[float] = None
        self._errors: list = []
        self._closed = False
        self._writer = threading.Thread(target=self._writer_loop,
                                        name="paddle_tpu_torch-ckpt-writer",
                                        daemon=True)
        self._writer.start()

    # -- the writer thread ---------------------------------------------------
    def _writer_loop(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            manifest, shards = item
            with self._cv:
                self._write_started = time.monotonic()
            try:
                publish_snapshot(self.directory, manifest, shards)
                self._prune()
                stat_add("STAT_checkpoint_async_writes")
            except BaseException as e:   # re-raised on the training thread
                with self._cv:
                    self._errors.append(e)
            finally:
                del item, shards
                with self._cv:
                    self._write_started = None
                    self._outstanding -= 1
                    _obs()[1].set(self._outstanding)
                    self._cv.notify_all()

    def _raise_pending(self):
        with self._cv:
            if self._errors:
                e = self._errors.pop(0)
                raise RuntimeError(
                    "async checkpoint write failed on the writer thread: "
                    f"{type(e).__name__}: {e}") from e
            started = self._write_started
        if (started is not None and self._watchdog_seconds is not None
                and time.monotonic() - started > self._watchdog_seconds):
            raise ExecutionTimeoutError(
                f"async checkpoint write has been running for over "
                f"{self._watchdog_seconds:.0f}s (a wedged filesystem?): "
                "checkpoints are no longer landing")

    # -- API -----------------------------------------------------------------
    def save(self, state_tree, step: int, extra_meta: Optional[dict] = None):
        """Snapshot on the caller, write on the writer thread.  Blocks only
        while ``max_in_flight`` earlier saves are still queued or being
        written, and re-raises a pending writer failure or watchdog."""
        _single_process()
        self._raise_pending()
        if self._closed:
            raise RuntimeError("AsyncCheckpointManager is closed")
        stat_add("STAT_checkpoint_saves")
        stall_h, inflight_g = _obs()
        t0 = time.perf_counter()
        manifest, shards = snapshot_tree(state_tree, step, extra_meta,
                                         pinned=True)
        with self._cv:
            self._outstanding += 1
            inflight_g.set(self._outstanding)
        while True:
            try:
                # a bounded put that re-checks the watchdog while blocked
                self._queue.put((manifest, shards), timeout=0.5)
                break
            except queue.Full:
                try:
                    self._raise_pending()
                except BaseException:
                    with self._cv:
                        self._outstanding -= 1
                        inflight_g.set(self._outstanding)
                        self._cv.notify_all()
                    raise
        stall_h.observe(time.perf_counter() - t0)
        self._last_saved_step = step
        self._last_saved_time = time.monotonic()
        return os.path.join(self.directory, f"step-{step:09d}")

    def save_train_state(self, params, opt_state, step: int,
                         extra_meta: Optional[dict] = None, optimizer=None,
                         scaler=None, data_cursor: Optional[dict] = None,
                         *, generator: Optional[torch.Generator] = None):
        """``save_train_state`` through the writer thread (the random
        stream, scheduler, scaler and cursor extras included)."""
        extra = train_state_extras(optimizer, extra_meta, scaler,
                                   data_cursor, generator=generator)
        return self.save({"params": params, "opt": opt_state}, step, extra)

    def wait_until_finished(self, timeout: Optional[float] = None) -> bool:
        """Block until every accepted save is published.  False on
        timeout; re-raises writer errors and the watchdog."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._outstanding > 0:
                wait = 0.5
                if deadline is not None:
                    wait = min(wait, deadline - time.monotonic())
                    if wait <= 0:
                        return False
                self._cv.wait(wait)
                self._raise_pending()   # the Condition's lock is an RLock
        self._raise_pending()
        return True

    def restore_latest(self, mesh=None, shardings=None):
        self.wait_until_finished()
        return super().restore_latest(mesh=mesh, shardings=shardings)

    def close(self, timeout: Optional[float] = None):
        """Flush pending writes and stop the writer.  Bounded even with a
        wedged writer: further saves are refused, the stop sentinel is
        delivered if the queue has room, and the join waits 5 s at most
        (the writer is a daemon thread)."""
        if self._closed:
            return
        self._closed = True
        try:
            self.wait_until_finished(timeout)
        finally:
            try:
                self._queue.put_nowait(None)
            except queue.Full:
                pass
            self._writer.join(timeout=5.0)


def train_epoch_range(n_epochs: int, manager: CheckpointManager):
    """The epochs not yet completed according to the newest checkpoint's
    ``extra["epoch"]`` (the reference's ``acp.train_epoch_range``); the
    caller saves with ``extra_meta={"epoch": e}`` at each epoch's end."""
    start = 0
    restored = latest_step_dir(manager.directory)
    if restored is not None:
        with open(os.path.join(restored, "manifest.json")) as f:
            extra = json.load(f).get("extra", {})
        if "epoch" in extra:
            start = int(extra["epoch"]) + 1
    for e in range(start, n_epochs):
        yield e
