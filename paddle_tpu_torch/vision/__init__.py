"""Vision (port of the reference's ``vision/``): the ResNet family of the
model zoo.  The rest of the zoo is ROADMAP A9; the datasets, transforms and
vision ops are A10 and raise on use."""

from . import models  # noqa: F401

_UNPORTED = frozenset({"datasets", "ops", "transforms"})


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            f"vision.{name} is not ported yet (ROADMAP A10: vision datasets, transforms "
            "and ops)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
