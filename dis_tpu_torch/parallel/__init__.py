from .batch import batched_flow_epe_fn, batched_flow_fn

__all__ = ["batched_flow_fn", "batched_flow_epe_fn"]
