from .mesh import make_mesh  # noqa: F401
from .ulysses import (  # noqa: F401
    all_to_all_heads_to_seq,
    all_to_all_seq_to_heads,
    gather_sequence,
    slice_local,
)
