from .linalg import matmul  # noqa: F401
from .manipulation import flatten  # noqa: F401
