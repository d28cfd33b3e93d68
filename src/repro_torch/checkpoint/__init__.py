from .manager import CheckpointManager
