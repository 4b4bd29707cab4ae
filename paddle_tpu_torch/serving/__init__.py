"""Continuous-batching serving (port of paddle_tpu.serving, engine core)."""
from .engine import (NonFiniteLogitsError, PreemptedRun,  # noqa: F401
                     ServingEngine)
from .kv_pool import KVPoolExhaustedError, PagedKVPool  # noqa: F401
from .prefix_cache import PrefixCache  # noqa: F401
from .request import Request, RequestCancelled, Response  # noqa: F401
from .scheduler import (DeadlineExceededError, QueueFullError,  # noqa: F401
                        RequestScheduler)
