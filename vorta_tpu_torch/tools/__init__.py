"""tools of vorta_tpu_torch."""
