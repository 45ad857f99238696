"""Fault-tolerant checkpointing."""
from .manager import CheckpointManager, load_pytree, save_pytree
