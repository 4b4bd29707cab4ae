from .linalg import matmul  # noqa: F401
