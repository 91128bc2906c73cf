"""Framework pieces of the port: the runtime flag registry (``flags``), the
dtype names (``dtype``), the random state (``random``: ``seed``,
``Generator``, the device states, key scopes), ``ParamAttr``
(``param_attr``) and ``save``/``load`` (``io``).  The names the reference
exports here (``framework/__init__.py:3-5``) are importable from it."""

from . import dtype, flags, random  # noqa: F401
from .flags import flag_guard, get_flags, set_flags  # noqa: F401
from .random import (Generator, default_generator, get_rng_state, key_scope,  # noqa: F401
                     seed, set_rng_state)

__all__ = [
    "dtype", "flags", "random",
    "get_flags", "set_flags", "flag_guard",
    "seed", "Generator", "default_generator", "get_rng_state", "set_rng_state", "key_scope",
]
