"""Typed error classes + enforce helpers (copy of paddle_tpu/core/errors.py).

Reference: paddle/fluid/platform/enforce.h (PADDLE_ENFORCE* macros raising
EnforceNotMet with a typed error code) and paddle/fluid/platform/errors.h
(the 12-code taxonomy: InvalidArgument, NotFound, OutOfRange, AlreadyExists,
ResourceExhausted, PreconditionNotMet, PermissionDenied, ExecutionTimeout,
Unimplemented, Unavailable, Fatal, External).  Each code is a
Python exception that ALSO subclasses the builtin users naturally catch
(InvalidArgumentError is a ValueError, NotFoundError a FileNotFoundError,
…), so framework call sites can raise typed errors without breaking
existing `except ValueError` handling.  The port keeps its own copy so
that it never imports the JAX package; the serving tests match on these
types.
"""
from __future__ import annotations

__all__ = [
    "EnforceNotMet", "InvalidArgumentError", "NotFoundError",
    "OutOfRangeError", "AlreadyExistsError", "ResourceExhaustedError",
    "PreconditionNotMetError", "PermissionDeniedError",
    "ExecutionTimeoutError", "UnimplementedError", "UnavailableError",
    "FatalError", "ExternalError", "enforce", "enforce_eq",
]


class EnforceNotMet(Exception):
    """Base of every typed framework error (enforce.h EnforceNotMet)."""
    code = "Unknown"


class InvalidArgumentError(EnforceNotMet, ValueError):
    code = "InvalidArgument"


class NotFoundError(EnforceNotMet, FileNotFoundError):
    code = "NotFound"


class OutOfRangeError(EnforceNotMet, IndexError):
    code = "OutOfRange"


class AlreadyExistsError(EnforceNotMet, FileExistsError):
    code = "AlreadyExists"


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    code = "ResourceExhausted"


class PreconditionNotMetError(EnforceNotMet, RuntimeError):
    code = "PreconditionNotMet"


class PermissionDeniedError(EnforceNotMet, PermissionError):
    code = "PermissionDenied"


class ExecutionTimeoutError(EnforceNotMet, TimeoutError, RuntimeError):
    # RuntimeError base kept for continuity: timeout paths (DataLoader)
    # raised RuntimeError before the taxonomy existed
    code = "ExecutionTimeout"


class UnimplementedError(EnforceNotMet, NotImplementedError):
    code = "Unimplemented"


class UnavailableError(EnforceNotMet, RuntimeError):
    code = "Unavailable"


class FatalError(EnforceNotMet, RuntimeError):
    code = "Fatal"


class ExternalError(EnforceNotMet, OSError):
    code = "External"


def enforce(cond, message, error=InvalidArgumentError):
    """PADDLE_ENFORCE: raise `error` with the typed-code prefix when cond
    is falsy."""
    if not cond:
        raise error(f"[{error.code}] {message}")


def enforce_eq(a, b, message="", error=InvalidArgumentError):
    """PADDLE_ENFORCE_EQ."""
    if a != b:
        raise error(f"[{error.code}] expected {a!r} == {b!r}. {message}")
