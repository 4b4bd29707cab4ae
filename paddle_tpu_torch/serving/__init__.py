"""Continuous-batching serving (port of paddle_tpu.serving, engine core)."""
from .engine import NonFiniteLogitsError, ServingEngine  # noqa: F401
from .kv_pool import KVPoolExhaustedError, PagedKVPool  # noqa: F401
from .request import Request, RequestCancelled, Response  # noqa: F401
from .scheduler import (DeadlineExceededError, QueueFullError,  # noqa: F401
                        RequestScheduler)
