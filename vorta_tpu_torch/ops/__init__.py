"""ops of vorta_tpu_torch: the package re-exports vorta_tpu.ops's names
(the coreset pool and the tile layout), and stays light to import: the
kernel wrappers are imported by their module paths."""

from .coreset import pool_by_similarity, unpool_by_similarity  # noqa: F401
from .layout import tile_sequence, untile_sequence  # noqa: F401
