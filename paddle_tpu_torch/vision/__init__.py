"""Vision (port of the reference's ``vision/``): the model zoo
(``vision.models``, every model of the reference).  The datasets,
transforms and vision ops are ROADMAP A10 and raise on use."""

from . import models  # noqa: F401

_UNPORTED = frozenset({"datasets", "ops", "transforms"})


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            f"vision.{name} is not ported yet (ROADMAP A10: vision datasets, transforms "
            "and ops)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
