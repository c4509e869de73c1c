"""Router-distillation training (counterpart of vorta_tpu/training)."""

from .sampling import rebalance_loss_weights, renormalize_uniform, sample_timesteps  # noqa: F401
from .step import LossWeights, make_router_train_step, router_partition  # noqa: F401
