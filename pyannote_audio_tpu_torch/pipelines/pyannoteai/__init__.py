from .local import Local
from .sdk import SDK

__all__ = ["SDK", "Local"]
