from .device import resolve_device
from .math import lower_bound, ste_round

__all__ = ["resolve_device", "lower_bound", "ste_round"]
