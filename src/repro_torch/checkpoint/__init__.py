"""Checkpoints: the ``Checkpointer`` store for trees of tensors and the
durable snapshots behind ``Program.stream(checkpoint_dir=...)`` and
``Program.run_checkpointed``, on the reference's on-disk format."""
from repro_torch.checkpoint.checkpointer import (STREAM_CKPT_VERSION,
                                                 CheckpointIntegrityError,
                                                 Checkpointer,
                                                 load_stream_checkpoint,
                                                 save_stream_checkpoint,
                                                 stream_checkpoint_steps)

__all__ = ["Checkpointer", "CheckpointIntegrityError", "STREAM_CKPT_VERSION",
           "load_stream_checkpoint", "save_stream_checkpoint",
           "stream_checkpoint_steps"]
