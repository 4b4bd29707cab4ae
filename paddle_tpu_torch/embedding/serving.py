"""Micro-batched, cross-request-deduped CTR scoring (counterpart of
paddle_tpu/embedding/serving.py).

Concurrent ``submit()``s are merged by a scorer thread: one dedup over
every merged request's ids, one host-table row fetch, one forward of the
external-embedding model on the device.  A full queue gives an already
terminal, failed response (the gateway's admission contract), never an
exception on the submit path.  ``inference.Config.enable_recsys_serving``
routes ``create_predictor`` here.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from .host_table import HostEmbeddingTable, _round_bucket

__all__ = ["RecsysPredictor", "RecsysResponse"]


class RecsysResponse:
    """Terminal, thread-safe result handle of one scoring request."""

    def __init__(self):
        self._event = threading.Event()
        self._scores: Optional[np.ndarray] = None
        self._error: Optional[str] = None

    def _finish(self, scores=None, error=None):
        self._scores = scores
        self._error = error
        self._event.set()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def failed(self) -> bool:
        return self._event.is_set() and self._error is not None

    @property
    def error(self) -> Optional[str]:
        return self._error

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("recsys scoring request still pending")
        if self._error is not None:
            raise RuntimeError(self._error)
        return self._scores


class RecsysPredictor:
    """Batched deduped-lookup scorer over an external-embedding model
    (``forward(dense, emb)``, emb the gathered (B, F, D) rows) and a
    host-resident ``table`` (a ``HostEmbeddingTable`` or a (rows, dim)
    ndarray); ``offsets`` maps per-feature ids into the concatenated
    table.  The parameters are the reference's, then ``device`` (default
    the model's)."""

    def __init__(self, model, table, offsets=None, max_batch: int = 256,
                 window_ms: float = 2.0, max_queue: int = 1024,
                 slab_bucket: int = 256, start: bool = True, *, device=None):
        if isinstance(table, np.ndarray):
            table = HostEmbeddingTable(table.shape[0], table.shape[1],
                                       dtype=table.dtype, rows=table)
        self.model = model.eval()
        self.device = (next(iter(model.state_dict().values())).device
                       if device is None else resolve_device(device))
        self.table = table
        self.offsets = (None if offsets is None
                        else np.asarray(offsets, np.int64).reshape(1, -1))
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1e3
        self.slab_bucket = int(slab_bucket)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, max_queue))
        self._d = table.embedding_dim
        self.requests = 0
        self.rejected = 0
        self.batches = 0
        self.scored = 0
        self.score_seconds = 0.0
        self._closed = False
        # the closed check and the enqueue against close(): a submit can
        # never land after close()'s drain
        self._submit_lock = threading.Lock()
        self._thread = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="pdtpu-recsys-scorer", daemon=True)
            self._thread.start()

    # -- submission ----------------------------------------------------------
    def submit(self, dense, ids) -> RecsysResponse:
        """Enqueue one request (dense (b, dense_dim), ids (b, F)); a full
        queue or a closed predictor gives an already-failed response."""
        resp = RecsysResponse()
        self.requests += 1
        item = (np.asarray(dense), np.asarray(ids), resp)
        with self._submit_lock:
            if self._closed:
                resp._finish(error="recsys predictor is closed")
                return resp
            try:
                self._queue.put_nowait(item)
            except queue.Full:
                self.rejected += 1
                from ..utils.monitor import stat_add
                stat_add("STAT_embedding_serving_rejects")
                resp._finish(error="recsys scoring queue full (shed)")
        return resp

    def predict(self, dense, ids, timeout: float = 30.0) -> np.ndarray:
        """submit + wait."""
        return self.submit(dense, ids).result(timeout)

    # -- scorer loop ---------------------------------------------------------
    def _drain_window(self):
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        items = [first]
        deadline = time.perf_counter() + self.window_s
        rows = first[0].shape[0]
        while rows < self.max_batch and time.perf_counter() < deadline:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                time.sleep(self.window_s / 10)
                continue
            items.append(item)
            rows += item[0].shape[0]
        return items

    def _loop(self):
        while not self._closed:
            items = self._drain_window()
            if not items:
                continue
            try:
                self.score_batch(items)
            except Exception as e:  # noqa: BLE001 — terminal per request
                for _, _, resp in items:
                    if not resp.done:
                        resp._finish(error=f"scoring failed: "
                                           f"{type(e).__name__}: {e}")

    @torch.no_grad()
    def score_batch(self, items):
        """Score merged ``(dense, ids, response)`` items with one dedup,
        one row fetch and one forward."""
        from ..utils.monitor import stat_add
        t0 = time.perf_counter()
        dense = np.concatenate([d for d, _, _ in items], axis=0)
        ids = np.concatenate([i for _, i, _ in items], axis=0)
        if self.offsets is not None:
            ids = ids.astype(np.int64) + self.offsets
        n, f = ids.shape
        uids, inv = np.unique(ids.reshape(-1), return_inverse=True)
        stat_add("STAT_embedding_rows_gathered", int(ids.size))
        stat_add("STAT_embedding_rows_unique", int(uids.size))
        cap = _round_bucket(len(uids), self.slab_bucket)
        slab = np.zeros((cap, self._d), self.table.rows.dtype)
        slab[:len(uids)] = self.table.rows[uids]
        stat_add("STAT_embedding_host_to_device_bytes", int(slab.nbytes))
        dev = self.device
        rows = torch.from_numpy(slab).to(dev)
        inv_t = torch.from_numpy(inv.reshape(-1).astype(np.int64)).to(dev)
        emb = rows[inv_t].reshape(n, f, self._d)
        out = self.model(torch.from_numpy(dense).to(dev), emb)
        scores = out.float().cpu().numpy()
        self.batches += 1
        self.scored += n
        self.score_seconds += time.perf_counter() - t0
        at = 0
        for d, _, resp in items:
            b = d.shape[0]
            resp._finish(scores=scores[at:at + b])
            at += b

    # -- lifecycle -----------------------------------------------------------
    def metrics(self) -> dict:
        return {"requests": self.requests, "rejected": self.rejected,
                "batches": self.batches, "scored": self.scored,
                "mean_merge": (self.scored / self.batches
                               if self.batches else None),
                "queue_depth": self._queue.qsize(),
                "score_seconds": self.score_seconds}

    def close(self):
        with self._submit_lock:
            self._closed = True
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        while True:
            try:
                _, _, resp = self._queue.get_nowait()
            except queue.Empty:
                break
            if not resp.done:
                resp._finish(error="recsys predictor closed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
