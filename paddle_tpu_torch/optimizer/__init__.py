from .optimizer import Adam, AdamW, Optimizer  # noqa: F401

__all__ = ["Optimizer", "Adam", "AdamW"]
