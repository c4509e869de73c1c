"""pipelines of vorta_tpu_torch."""

from .wan_t2v import SamplingConfig, WanT2VPipeline  # noqa: F401
