from .device import DEFAULT_DEVICE, resolve_device  # noqa: F401
