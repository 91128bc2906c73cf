"""Fused operators outside the core API (port of the reference's
``incubate/``): the fused functionals and layers (``incubate.nn``), n:m
sparsity (``incubate.asp``) and the layout autotuner.  MoE
(``incubate.distributed``) is not ported yet."""

from . import asp, autotune, nn  # noqa: F401

_UNPORTED = frozenset({"distributed"})


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            f"incubate.{name} is not ported yet (ROADMAP A9: MoE Llama and its expert axis)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
