"""Router-distillation training (counterpart of vorta_tpu/training)."""
