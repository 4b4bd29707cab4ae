"""Device resolution for the port's entry points.

Counterpart of ``paddle_tpu/core/device.py``.  Entry points (model
constructors, ``generate``, ``ServingEngine``) run on the card unless the
caller asks for the CPU: the default is ``"cuda"``, and a missing card
raises instead of quietly running somewhere else.
"""
from __future__ import annotations

import torch

from .errors import InvalidArgumentError, UnavailableError

__all__ = ["resolve_device", "DEFAULT_DEVICE"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``"cuda"`` / ``"cuda:N"`` / ``"cpu"`` (or a torch.device) -> a
    torch.device.  Raises UnavailableError for a CUDA device when no card
    is present, InvalidArgumentError for any other device type."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise UnavailableError(
                "no CUDA device is available: pass device='cpu' to run the "
                "port on the CPU (its kernels then take their plain "
                "versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise InvalidArgumentError(
            f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
