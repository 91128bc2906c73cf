"""Distributed training utilities of the port (so far: ``fleet_utils``'s
activation recompute)."""
