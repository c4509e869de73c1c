"""models of vorta_tpu_torch."""

from .router import Router  # noqa: F401
from .wan import WanBlock, WanModel  # noqa: F401
