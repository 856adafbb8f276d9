"""Checkpoints of the port, in the JAX package's on-disk format."""
from .io import (save_checkpoint, restore_checkpoint, read_checkpoint,  # noqa
                 latest_step, list_checkpoints)
