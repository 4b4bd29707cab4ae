"""L1 / L2 weight-decay regularizers (counterpart of
paddle_tpu/regularizer.py).

The regularizer adds its penalty gradient, ``coeff * sign(w)`` for L1 and
``coeff * w`` for L2, to each trainable parameter's gradient before the
optimizer's update.  An optimizer takes the object as its
``weight_decay`` (``Momentum(..., weight_decay=L2Decay(1e-4))``) and folds
the penalty into its multi-tensor update; a parameter made with
``ParamAttr(regularizer=...)`` overrides it in the eager step, as in the
reference.
"""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class _Decay:
    mode: str = ""

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L1Decay(_Decay):
    """Lasso: penalty gradient ``coeff * sign(w)``."""
    mode = "l1"


class L2Decay(_Decay):
    """Ridge: penalty gradient ``coeff * w``."""
    mode = "l2"
