"""Checkpoints of the port (counterpart of ``repro/ckpt``)."""
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: F401
