"""The dataset engine: InMemoryDataset and QueueDataset (counterpart of
paddle_tpu/distributed/dataset.py).

Records are text lines ``label<TAB>f1 f2 ...`` (commas count as spaces;
a line of another width, or that does not parse, is skipped whole: the
reference's parser keeps the label of a line whose values fail, which
misaligns its labels with its rows) or, with
``binary=True``, fixed records of an int64 label and ``feature_dim``
f32 values.

- Parsing: the reference reads with its native C++ datafeed when that
  builds; the port has no ``native/`` yet (ROADMAP item 9d), so it reads
  with its own copy of the reference's same-format Python parser.
  ``load_into_memory`` parses the files on ``thread_num`` threads, and
  keeps them in file-list order.
- ``global_shuffle`` sorts the rows into a canonical order (by every
  feature, then the label), applies the seeded ``numpy`` ``RandomState``
  permutation and keeps rank r of n's strided slice [r::n]: every rank
  agrees without exchanging rows, and each rank's order is the
  reference's, element for element.
- ``local_shuffle`` permutes this process's rows in place.
- ``QueueDataset`` streams batches file by file (one pass, only a
  partial batch carried across files), re-reading the files on each
  iteration.

Batches are numpy (features (n, dim) f32, labels (n,) int64), as the
reference yields them; a trainer copies them to the card.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["InMemoryDataset", "QueueDataset"]


def _parse_text_py(path: str, dim: int):
    feats, labels = [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().replace(",", " ").split()
            if len(parts) != dim + 1:
                continue
            try:
                label, row = int(parts[0]), [float(v) for v in parts[1:]]
            except ValueError:
                continue
            labels.append(label)
            feats.append(row)
    return (np.asarray(feats, np.float32).reshape(-1, dim),
            np.asarray(labels, np.int64))


def _parse_binary_py(path: str, dim: int):
    rec = np.dtype([("label", "<i8"), ("feat", "<f4", (dim,))])
    data = np.fromfile(path, dtype=rec)
    return (np.ascontiguousarray(data["feat"], np.float32),
            np.ascontiguousarray(data["label"], np.int64))


def _parse_file_py(path: str, dim: int, binary: bool):
    return (_parse_binary_py if binary else _parse_text_py)(path, dim)


class _DatasetBase:
    def __init__(self):
        self._filelist: List[str] = []
        self._batch_size = 1
        self._thread_num = 1
        self._dim: Optional[int] = None
        self._binary = False
        self._drop_last = False

    def init(self, batch_size=1, thread_num=1, feature_dim=None,
             use_var=None, binary=False, drop_last=False, **kw):
        self._batch_size = int(batch_size)
        self._thread_num = int(thread_num)
        if feature_dim is not None:
            self._dim = int(feature_dim)
        self._binary = bool(binary)
        self._drop_last = bool(drop_last)

    def set_filelist(self, filelist: Sequence[str]):
        self._filelist = list(filelist)

    def get_filelist(self):
        return list(self._filelist)

    def set_batch_size(self, batch_size: int):
        self._batch_size = int(batch_size)

    def set_thread(self, thread_num: int):
        self._thread_num = int(thread_num)

    def set_feature_dim(self, dim: int):
        self._dim = int(dim)

    def _require_dim(self):
        if self._dim is None:
            raise ValueError(
                "feature_dim not set: call init(feature_dim=...) or "
                "set_feature_dim() (records are label + dim floats)")


class InMemoryDataset(_DatasetBase):
    """init -> set_filelist -> load_into_memory -> [local | global]_shuffle
    -> iterate batches (this rank's slice after a global shuffle)."""

    def __init__(self):
        super().__init__()
        self._feats: Optional[np.ndarray] = None
        self._labels: Optional[np.ndarray] = None
        self._order: Optional[np.ndarray] = None
        self._epoch_seed = 0

    def load_into_memory(self):
        """Parse every file, ``thread_num`` at a time, in file-list
        order."""
        self._require_dim()
        if not self._filelist:
            raise ValueError("set_filelist before load_into_memory")
        workers = max(1, min(self._thread_num, len(self._filelist)))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            parts = list(pool.map(
                lambda p: _parse_file_py(p, self._dim, self._binary),
                self._filelist))
        self._feats = np.concatenate([f for f, _ in parts])
        self._labels = np.concatenate([lab for _, lab in parts])
        self._order = np.arange(len(self._labels))

    def preload_into_memory(self):
        self.load_into_memory()

    def wait_preload_done(self):
        pass

    def local_shuffle(self, seed: Optional[int] = None):
        """Shuffle this process's rows only."""
        self._check_loaded()
        rng = np.random.RandomState(self._next_seed(seed))
        rng.shuffle(self._order)

    def global_shuffle(self, fleet=None, thread_num: Optional[int] = None,
                       seed: Optional[int] = None):
        """The seeded permutation of the canonically sorted rows, this
        rank's strided slice of it (ranks from ``fleet``'s worker_index /
        worker_num, else the process group's)."""
        self._check_loaded()
        canon = np.lexsort(
            tuple(self._feats[:, d] for d in range(self._feats.shape[1]))
            + (self._labels,))
        rng = np.random.RandomState(self._next_seed(seed))
        perm = rng.permutation(len(self._labels))
        rank, nranks = self._rank_info(fleet)
        self._order = canon[perm][rank::nranks]

    def _next_seed(self, seed):
        if seed is not None:
            return int(seed)
        self._epoch_seed += 1
        return self._epoch_seed

    @staticmethod
    def _rank_info(fleet):
        if fleet is not None and hasattr(fleet, "worker_index"):
            return int(fleet.worker_index()), max(
                1, int(fleet.worker_num()))
        from .env import get_rank, get_world_size
        return get_rank(), max(1, get_world_size())

    def release_memory(self):
        self._feats = self._labels = self._order = None

    def get_memory_data_size(self) -> int:
        return 0 if self._labels is None else int(len(self._labels))

    def get_shuffle_data_size(self) -> int:
        return 0 if self._order is None else int(len(self._order))

    def _check_loaded(self):
        if self._feats is None:
            raise RuntimeError("load_into_memory first")

    def __iter__(self):
        self._check_loaded()
        bs, order = self._batch_size, self._order
        for i in range(0, len(order), bs):
            idx = order[i:i + bs]
            if len(idx) < bs and self._drop_last:
                return
            yield self._feats[idx], self._labels[idx]

    def __len__(self):
        n = self.get_shuffle_data_size()
        if self._drop_last:
            return n // self._batch_size
        return (n + self._batch_size - 1) // self._batch_size


class QueueDataset(_DatasetBase):
    """One streaming pass over the files per iteration; nothing held in
    memory beyond one file and a partial batch."""

    def __iter__(self):
        self._require_dim()
        if not self._filelist:
            raise ValueError("set_filelist before iterating")
        bs = self._batch_size
        rem_f = np.zeros((0, self._dim), np.float32)
        rem_l = np.zeros((0,), np.int64)
        for path in self._filelist:
            f, lab = _parse_file_py(path, self._dim, self._binary)
            f = np.concatenate([rem_f, f])
            lab = np.concatenate([rem_l, lab])
            full = (len(lab) // bs) * bs
            for i in range(0, full, bs):
                yield f[i:i + bs], lab[i:i + bs]
            rem_f, rem_l = f[full:], lab[full:]
        if len(rem_l) and not self._drop_last:
            yield rem_f, rem_l
