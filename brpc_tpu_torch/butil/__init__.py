"""Base utilities of the port (device selection)."""

from .device import resolve_device

__all__ = ["resolve_device"]
