"""Checkpoints in the reference's on-disk format, with async save."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
from repro_torch.checkpoint.serializer import load_tree, save_tree  # noqa: F401
