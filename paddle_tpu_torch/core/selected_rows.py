"""Row-sparse gradients: the port's SelectedRows (counterpart of
paddle_tpu/core/selected_rows.py).

Reference: paddle/fluid/framework/selected_rows.h (a rows index vector and
a value tensor on a (height, width) frame, produced by sparse lookup-table
gradients) and paddle/fluid/operators/optimizers/adam_op.h (lazy mode:
only touched rows get a moment and parameter update).

A ``RowSparseGrad`` keeps the full lookup-count ``rows`` / ``values``
(duplicates included), so every shape is static; ``optimizer.sparse``'s
``merge_rows`` sums duplicates into buffers of the same shape with a
sentinel id for the slots past the unique rows, and the lazy row update
writes the touched rows only.

Two delivery paths:

- **Eager.** ``F.embedding(..., sparse=True)`` on a weight that requires
  grad runs ``eager_sparse_embedding``, whose backward hands torch's
  autograd a sparse COO tensor of the weight's shape: one index per lookup
  (uncoalesced, duplicates kept) and the per-lookup output gradients as
  values.  Gradients of several backwards accumulate by concatenation, as
  SelectedRows do.  ``RowSparseGrad.of(param.grad)`` is the reference's
  view of it (``rows``, ``values``, ``dense_shape``, ``to_dense()``);
  ``param.grad.to_dense()`` densifies.  ``Optimizer.step`` takes the lazy
  row update for such a gradient.
- **Step programs.** Inside ``jit.TrainStep`` a ``SparseGradContext`` is
  active.  A record pass notes each lookup's (count, width, dtype); the
  step then gives each lookup a zero leaf of that shape, which the lookup
  adds to rows gathered from the detached weight, so the zero leaf's
  gradient is the per-lookup gradient, and logs the lookup ids.  The step
  applies the same lazy update inside its program.

A sparse weight must be consumed only by ``F.embedding``: any other use
would lose its gradient, since the weight is not differentiated.
``dense_consumed_uses`` finds such uses in a probe's autograd graph (a
weight reached by the graph at all is one: the sanctioned lookup gathers
from its detached tensor); ``jit.TrainStep`` demotes such a weight to a
dense gradient with a warning, ``check_embedding_only_use`` raises.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

__all__ = ["RowSparseGrad", "SparseGradContext", "current_ctx", "use_ctx",
           "param_name", "ctx_embedding", "dense_consumed_uses",
           "dense_consumed_keys", "check_embedding_only_use",
           "eager_sparse_embedding", "dense_grad"]


class RowSparseGrad:
    """rows (N,) lookup ids and values (N, width) on a (height, width)
    frame.  Duplicate rows are allowed (the optimizer merges them).  ``+``
    with another RowSparseGrad concatenates (SelectedRows accumulation);
    with a dense tensor it densifies."""

    __slots__ = ("rows", "values", "dense_shape")

    def __init__(self, rows, values, dense_shape):
        self.rows = rows
        self.values = values
        self.dense_shape = tuple(int(s) for s in dense_shape)

    @classmethod
    def of(cls, grad: torch.Tensor) -> "RowSparseGrad":
        """The view of a sparse COO gradient (the eager path's)."""
        return cls(grad._indices()[0], grad._values(), grad.shape)

    @property
    def shape(self):
        return self.dense_shape

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def is_sparse(self):
        return True

    def to_dense(self) -> torch.Tensor:
        """Summed rows on the dense frame; ids past the frame (the merge's
        sentinel) are dropped."""
        h = self.dense_shape[0]
        out = torch.zeros((h + 1,) + self.dense_shape[1:],
                          dtype=self.values.dtype, device=self.values.device)
        out.index_add_(0, self.rows.long().clamp(0, h), self.values)
        return out[:h]

    def __add__(self, other):
        if isinstance(other, RowSparseGrad):
            dt = torch.promote_types(self.values.dtype, other.values.dtype)
            return RowSparseGrad(
                torch.cat([self.rows, other.rows]),
                torch.cat([self.values.to(dt), other.values.to(dt)]),
                self.dense_shape)
        return self.to_dense() + other

    __radd__ = __add__

    def numpy(self):
        """Dense materialization (``Tensor.gradient`` for sparse grads)."""
        return self.to_dense().detach().cpu().numpy()

    def __repr__(self):
        return (f"RowSparseGrad(rows={self.rows.shape[0]}, "
                f"dense_shape={self.dense_shape}, dtype={self.dtype})")


def _coo(rows, values, shape):
    return torch.sparse_coo_tensor(rows.long().reshape(1, -1), values,
                                   tuple(shape), check_invariants=False)


def dense_grad(grad):
    """A gradient as a dense tensor (a sparse COO one densified)."""
    if isinstance(grad, RowSparseGrad):
        return grad.to_dense()
    return grad.to_dense() if grad is not None and grad.is_sparse else grad


# ---------------------------------------------------------------------------
# step programs: the sparse-gradient context


class SparseGradContext:
    """The channel between ``F.embedding`` and a training step.

    mode "record": notes each sparse lookup's (n_lookups, width, dtype) in
    ``specs`` and gathers from the detached weight.  mode "apply": the
    lookup adds ``zeros[key]`` to the rows gathered from the detached
    weight (so the zero leaf's gradient is the per-lookup gradient) and
    logs the ids in ``ids``.  Keys are ``param_name@call_index``, stable
    across both passes because both run the same forward.  ``names`` maps
    ``id(weight)`` to its name (the step's state key); ``deny`` holds the
    names demoted to dense gradients."""

    def __init__(self, mode: str, zeros: Optional[Dict] = None, deny=(),
                 names: Optional[Dict[int, str]] = None):
        self.mode = mode
        self.zeros = zeros or {}
        self.deny = frozenset(deny)
        self.names = dict(names or {})
        self.specs: Dict[str, tuple] = {}
        self.ids: Dict[str, torch.Tensor] = {}
        self._counts: Dict[str, int] = {}

    def name_of(self, weight) -> str:
        return (self.names.get(id(weight))
                or getattr(weight, "param_name", None) or "embedding")

    def wants(self, name: str) -> bool:
        return name not in self.deny

    def key_for(self, name: str) -> str:
        i = self._counts.get(name, 0)
        self._counts[name] = i + 1
        return f"{name}@{i}"


_CTX: Optional[SparseGradContext] = None


def current_ctx() -> Optional[SparseGradContext]:
    return _CTX


@contextlib.contextmanager
def use_ctx(ctx: SparseGradContext):
    global _CTX
    prev = _CTX
    _CTX = ctx
    try:
        yield ctx
    finally:
        _CTX = prev


def param_name(key: str) -> str:
    return key.rsplit("@", 1)[0]


def _pad_rows(out, ids, padding_idx):
    if padding_idx is None:
        return out
    return torch.where((ids == padding_idx)[..., None],
                       torch.zeros((), dtype=out.dtype, device=out.device),
                       out)


def ctx_embedding(ctx: SparseGradContext, x, weight, padding_idx=None):
    """The lookup inside a step that collects sparse gradients."""
    ids = x.long()
    key = ctx.key_for(ctx.name_of(weight))
    width = weight.shape[1]
    rows = weight.detach()[ids]
    if ctx.mode == "record":
        ctx.specs[key] = (ids.numel(), width, weight.dtype)
    else:
        ctx.ids[key] = ids.reshape(-1)
        rows = rows + ctx.zeros[key].reshape(ids.shape + (width,))
    return _pad_rows(rows, ids, padding_idx)


# ---------------------------------------------------------------------------
# misuse guard: a sparse weight consumed outside F.embedding


def dense_consumed_uses(probe_fn, sparse_vals: Dict[str, torch.Tensor]):
    """(key, consuming autograd node) pairs for every sparse weight in
    ``sparse_vals`` (leaf tensors that require grad) that the loss
    ``probe_fn(sparse_vals)`` reaches through its autograd graph, that is
    through anything but the sanctioned lookup (which reads the detached
    weight).  The probe runs the forward with an active context."""
    loss = probe_fn(sparse_vals)
    tracked = {id(v): k for k, v in sparse_vals.items()}
    bad, seen = [], set()
    stack = [loss.grad_fn] if getattr(loss, "grad_fn", None) else []
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        for nxt, _ in node.next_functions:
            if nxt is None:
                continue
            var = getattr(nxt, "variable", None)
            if var is not None and id(var) in tracked:
                bad.append((tracked[id(var)], type(node).__name__))
            stack.append(nxt)
    return bad


def dense_consumed_keys(probe_fn, sparse_vals):
    """Just the offending keys (``TrainStep``'s demotion wants a set)."""
    return {k for k, _ in dense_consumed_uses(probe_fn, sparse_vals)}


def check_embedding_only_use(probe_fn, sparse_vals):
    """Raise ValueError if any sparse weight feeds anything but the
    lookup (a tied LM head, say).  ``TrainStep`` demotes such weights
    instead; this is for direct callers who want the hard guard."""
    bad = dense_consumed_uses(probe_fn, sparse_vals)
    if bad:
        uses = ", ".join(sorted({f"'{k}' used by {p}" for k, p in bad}))
        raise ValueError(
            "Embedding(sparse=True) weights must only be consumed via "
            f"F.embedding, but the traced forward also uses: {uses}. "
            "Those gradients would be silently dropped — untie the weight "
            "or use sparse=False.")


# ---------------------------------------------------------------------------
# eager path: a lookup whose weight gradient is row-sparse


class _SparseLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weight, ids, padding_idx):
        ctx.save_for_backward(ids)
        ctx.shape, ctx.pad = weight.shape, padding_idx
        return _pad_rows(weight[ids], ids, padding_idx)

    @staticmethod
    def backward(ctx, ct):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        vals = _pad_rows(ct.reshape(-1, ctx.shape[1]), flat, ctx.pad)
        return _coo(flat, vals, ctx.shape), None, None


def eager_sparse_embedding(x, weight, padding_idx=None):
    """The lookup whose weight gradient is a sparse COO tensor (one
    index per lookup, padding rows zero)."""
    return _SparseLookup.apply(weight, x.long(), padding_idx)

