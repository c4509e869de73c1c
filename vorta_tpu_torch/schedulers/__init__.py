"""schedulers of vorta_tpu_torch."""

from .flow_match import FlowMatchEulerSchedule  # noqa: F401
