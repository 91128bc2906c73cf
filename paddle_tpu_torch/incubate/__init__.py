"""Fused operators outside the core API (port of the reference's
``incubate/``): the fused functionals and layers (``incubate.nn``), n:m
sparsity (``incubate.asp``), the layout autotuner and the MoE layers,
gates and dispatch utilities (``incubate.distributed``)."""

from . import asp, autotune, distributed, nn  # noqa: F401
