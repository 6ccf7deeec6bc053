from .metrics import epe

__all__ = ["epe"]
