"""Hybrid-parallel building blocks (port of the reference's
``distributed/meta_parallel/``; so far context parallelism: ring attention
and Ulysses over a ``sep`` mesh)."""

from .context_parallel import ring_attention, ulysses_attention  # noqa: F401

__all__ = ["ring_attention", "ulysses_attention"]
