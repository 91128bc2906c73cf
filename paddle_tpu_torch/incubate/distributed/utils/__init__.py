from . import moe_utils  # noqa: F401
