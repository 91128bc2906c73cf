"""Distributed launch CLI (port of the reference's ``distributed/launch/``;
reference ``python/paddle/distributed/launch/``)."""

from .main import launch, main

__all__ = ["launch", "main"]
