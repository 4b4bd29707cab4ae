from .optimizer import Adam, AdamW, Momentum, Optimizer  # noqa: F401

__all__ = ["Optimizer", "Momentum", "Adam", "AdamW"]
