from .metrics import epe_torch

__all__ = ["epe_torch"]
