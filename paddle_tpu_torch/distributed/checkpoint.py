"""Training checkpoints in the reference's on-disk layout (the
single-process part of paddle_tpu/distributed/checkpoint.py).

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

Not in this slice of the port, raising ``UnimplementedError``:
``mesh=`` / ``shardings=`` (restoring onto a device mesh), a save from
more than one process, and ``AsyncCheckpointManager``.

The non-array training state rides in the manifest's ``extra`` under the
reference's keys (``__lr_sched__``, ``__data_cursor__``), except the
random stream: the reference saves its threefry key as ``__rng__``, which
means nothing to torch generators.  The port saves its seed stream and the
training step's generator under ``__torch_rng__`` instead, and leaves a
reference checkpoint's ``__rng__`` unused.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core import rng as _rng
from ..core.errors import InvalidArgumentError, UnimplementedError
from ..utils.monitor import stat_add

__all__ = ["snapshot_tree", "publish_snapshot", "save_sharded",
           "latest_step_dir", "restore_sharded", "train_state_extras",
           "save_train_state", "restore_train_extras", "apply_train_state",
           "merge_opt_state", "CheckpointManager"]

_LATER = ("comes with the port's parallel slice (torch.distributed); "
          "this slice saves and restores single-process checkpoints")
_STEP_DIR_RE = re.compile(r"^step-(\d+)$")
RNG_KEY = "__torch_rng__"
_BF16_WORDS = np.dtype("V2")   # how numpy stores an ml_dtypes bfloat16

_obs_handles = None


def _obs():
    """(save_stall_histogram, async_in_flight_gauge) — observability
    handles, created once (registry.reset() zeroes in place); the gauge
    stays 0 until the asynchronous manager is ported."""
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


def _single_process():
    dist = torch.distributed
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        raise UnimplementedError(f"a checkpoint from several processes "
                                 f"{_LATER}")


# -- host arrays ------------------------------------------------------------

def _host_array(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy; bf16 as numpy writes ml_dtypes'
    bfloat16 (its words in 2-byte voids)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_WORDS).copy()
    return t.numpy().copy()


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A CPU tensor of a restored array whose manifest dtype is ``dtype``."""
    if dtype == "bfloat16":
        words = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype)))


# -- save -------------------------------------------------------------------

def snapshot_tree(state_tree, step: int = 0,
                  extra_meta: Optional[dict] = None):
    """Copy every tensor of the tree to host memory and build the manifest.
    Returns (manifest, shards).  Each array is one shard (a whole array,
    spec ``[]``, replicated), as the reference's unsharded save."""
    flat = _flatten(state_tree)
    manifest = {"step": int(step), "arrays": {}, "extra": extra_meta or {},
                "n_processes": 1}
    shards = {}
    for name, t in flat.items():
        arr = _host_array(t)
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
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    _fsync_dir(directory)
    _write_atomic(os.path.join(directory, "latest"),
                  os.path.basename(step_dir))
    return step_dir


def save_sharded(state_tree, directory: str, step: int = 0,
                 extra_meta: Optional[dict] = None) -> str:
    """Write a checkpoint of a tree (nested dicts) of tensors; the whole
    save is observed as ``checkpoint_save_stall_seconds``.  Returns the
    step directory."""
    _single_process()
    os.makedirs(directory, exist_ok=True)
    stall_h, _ = _obs()
    with stall_h.time():
        manifest, shards = snapshot_tree(state_tree, step, extra_meta)
        return publish_snapshot(directory, manifest, shards)


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


def restore_sharded(directory: str, mesh=None, shardings=None,
                    step: Optional[int] = None):
    """(state_tree, step, extra_meta) from a checkpoint directory (the
    newest, or ``step``'s), the arrays as CPU tensors; None when there is
    no checkpoint."""
    if mesh is not None or shardings:
        raise UnimplementedError(f"restore_sharded(mesh=/shardings=) "
                                 f"{_LATER}")
    step_dir = (os.path.join(directory, f"step-{step:09d}")
                if step is not None else latest_step_dir(directory))
    if step_dir is None or not os.path.isdir(step_dir):
        return None
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    files = _shard_files(step_dir, manifest.get("n_processes"))
    out = {name: _to_tensor(_assemble(files, name, tuple(meta["shape"])),
                            meta["dtype"])
           for name, meta in manifest["arrays"].items()}
    return _unflatten(out), manifest["step"], manifest.get("extra", {})


# -- train-step glue (jit.TrainStep) ----------------------------------------

def _state_list(gen: torch.Generator) -> list:
    return gen.get_state().tolist()


def _state_tensor(values: list) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.uint8)


def train_state_extras(optimizer=None, extra_meta: Optional[dict] = None,
                       scaler=None, data_cursor: Optional[dict] = None,
                       generator: Optional[torch.Generator] = None) -> dict:
    """The non-array training state for a checkpoint's extra dict: the
    port's seed stream and the step's ``generator`` (``__torch_rng__``),
    the scheduler's state (``__lr_sched__``) and the data cursor
    (``__data_cursor__``)."""
    if scaler is not None:
        raise UnimplementedError(
            "a GradScaler's state comes with the port's GradScaler")
    extra = dict(extra_meta or {})
    extra[RNG_KEY] = {
        "stream": _state_list(_rng._stream),
        "step": None if generator is None else _state_list(generator),
        "step_device": None if generator is None else generator.device.type}
    sched = getattr(optimizer, "_lr_scheduler", None)
    if sched is not None:
        extra["__lr_sched__"] = sched.state_dict()
    if data_cursor is not None:
        extra["__data_cursor__"] = dict(data_cursor)
    return extra


def save_train_state(directory: str, params, opt_state, step: int,
                     extra_meta: Optional[dict] = None, optimizer=None,
                     scaler=None, data_cursor: Optional[dict] = None,
                     generator: Optional[torch.Generator] = None) -> str:
    """Parameters (and buffers), optimizer state and the extras, as the
    reference's ``{"params": ..., "opt": ...}`` tree."""
    stat_add("STAT_checkpoint_saves")
    extra = train_state_extras(optimizer, extra_meta, scaler, data_cursor,
                               generator)
    return save_sharded({"params": params, "opt": opt_state}, directory,
                        step, extra)


def restore_train_extras(optimizer, step: int, extra: dict, scaler=None,
                         generator: Optional[torch.Generator] = None) -> dict:
    """Apply the non-array state of a checkpoint's extra dict: the step
    count, the seed stream and (on a generator of the saved device type)
    the step's generator, the scheduler.  Pops the internal keys (a
    reference checkpoint's ``__rng__`` is dropped unused) and returns the
    user-facing meta; a saved data cursor comes back as
    ``meta["data_cursor"]``."""
    if scaler is not None:
        raise UnimplementedError(
            "a GradScaler's state comes with the port's GradScaler")
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
    extra.pop("__scaler__", None)
    cursor = extra.pop("__data_cursor__", None)
    if cursor is not None:
        extra["data_cursor"] = cursor
    return {"step": step, **extra}


@torch.no_grad()
def apply_train_state(model, optimizer, restored, scaler=None,
                      generator: Optional[torch.Generator] = None):
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
    meta = restore_train_extras(optimizer, step, extra, scaler, generator)
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
