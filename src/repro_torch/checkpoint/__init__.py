"""Checkpoints in the reference's on-disk format, with async save, and
elastic restore onto another mesh."""
from repro_torch.checkpoint.elastic import reshard_tree, restore_elastic  # noqa: F401
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
from repro_torch.checkpoint.serializer import load_tree, save_tree  # noqa: F401
