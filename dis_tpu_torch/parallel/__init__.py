from .batch import batched_flow_epe_fn, batched_flow_fn
from .tiles import (grid_tiled_flow, min_stripe_halo, stripe_bounds,
                    tiled_flow_exact, window_partition)

__all__ = ["batched_flow_fn", "batched_flow_epe_fn", "grid_tiled_flow",
           "min_stripe_halo", "stripe_bounds", "tiled_flow_exact",
           "window_partition"]
