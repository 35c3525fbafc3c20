"""repro_torch.ckpt — atomic checkpoints of trees of tensors."""
from repro_torch.ckpt.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
