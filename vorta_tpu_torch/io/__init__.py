"""io of vorta_tpu_torch."""

from .checkpoint import (  # noqa: F401
    latest_checkpoint,
    load_router_checkpoint,
    save_router_checkpoint,
)
from .metrics import MetricsLogger  # noqa: F401
