"""Distributed utilities of the port (so far: ``fleet_utils``'s activation
recompute, and ``topology`` with ``meta_parallel.context_parallel`` over a
``sep`` mesh of the devices one process drives)."""
