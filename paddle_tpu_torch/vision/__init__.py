"""Vision (port of the reference's ``vision/``): the ResNet family of the
model zoo.  The rest of the zoo, the datasets, transforms and vision ops
are not ported yet (ROADMAP A9)."""

from . import models  # noqa: F401
