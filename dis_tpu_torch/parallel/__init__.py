from .mesh import make_mesh, batch_sharding, row_sharding
from .batch import batched_flow_fn, batched_flow_epe_fn
from .tiles import (tiled_flow_fn, tiled_flow_exact, grid_tiled_flow,
                    grid_tiled_flow_fn, stripe_bounds,
                    min_stripe_halo, exchange_halo, window_partition)
from .sequence import sequence_flow_fn, sequence_pair_flow_fn

__all__ = [
    "make_mesh", "batch_sharding", "row_sharding",
    "batched_flow_fn", "batched_flow_epe_fn",
    "tiled_flow_fn", "tiled_flow_exact", "grid_tiled_flow",
    "grid_tiled_flow_fn", "stripe_bounds",
    "min_stripe_halo", "exchange_halo", "window_partition",
    "sequence_flow_fn", "sequence_pair_flow_fn",
]
