"""ParamAttr: a parameter's name, initializer, learning-rate multiplier,
regularizer, trainable flag and clip exemption (a copy of the reference's
``framework/param_attr.py``, which holds no JAX).

``Layer.create_parameter`` reads every field: the initializer draws the
value, ``trainable=False`` gives a parameter without grad, and the
parameter carries ``optimize_attr["learning_rate"]`` (the optimizers'
learning-rate multiplier), ``regularizer`` and ``need_clip`` (the
gradient clips leave such a parameter out), as in the reference.  The
optimizers' coupled decay leaves out a parameter whose ``regularizer`` is
set (the optimizer's ``weight_decay`` does not apply to it), as the
reference's ``_coupled_decay`` does.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None, trainable: bool = True,
                 do_model_average: bool = True, need_clip: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr) -> Optional["ParamAttr"]:
        """Normalize weight_attr/bias_attr layer args: ParamAttr | None | False
        | Initializer | str(name)."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return None
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        # an Initializer instance
        return ParamAttr(initializer=attr)
