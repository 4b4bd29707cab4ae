from . import lr  # noqa: F401
from .averaging import ExponentialMovingAverage, Lookahead, ModelAverage  # noqa: F401,E501
from .dgc import DGCMomentum  # noqa: F401
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,  # noqa: F401
                        DecayedAdagrad, Dpsgd, Ftrl, Lamb, LarsMomentum,
                        Momentum, Optimizer, RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "RMSProp", "Adadelta", "Lamb", "LarsMomentum",
           "DecayedAdagrad", "Dpsgd", "Ftrl", "DGCMomentum",
           "ExponentialMovingAverage", "ModelAverage", "Lookahead", "lr"]
