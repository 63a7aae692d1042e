"""Checkpoints of the port: the reference's npz + JSON manifest format
(``repro_torch.checkpoint.ckpt``)."""

from repro_torch.checkpoint.ckpt import (
    AsyncCheckpointer,
    CheckpointError,
    apply_patch,
    checkpoint_steps,
    dict_diff,
    latest_step,
    load_manifest,
    load_resolved_manifest,
    prune_checkpoints,
    reshard,
    restore_checkpoint,
    save_checkpoint,
    validate_checkpoint,
)
