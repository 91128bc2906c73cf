"""incubate.distributed — experimental distributed models (MoE)."""

from . import models  # noqa: F401
from . import utils  # noqa: F401
