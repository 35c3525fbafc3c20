"""Serving primitives shared by the port's farm: the slot table."""
from repro_torch.serve.slots import SlotTable

__all__ = ["SlotTable"]
