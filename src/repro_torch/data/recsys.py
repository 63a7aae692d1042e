"""Synthetic CTR batches with a planted click signal (the port of
``repro.data.recsys``; numpy, bit-equal to the reference)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.state import resolve_device


def recsys_batch(step: int, batch: int, n_sparse: int, vocab: int,
                 n_dense: int, n_crosses: int, seed: int = 0):
    rng = np.random.default_rng(seed * 7_000_003 + step)
    sparse = rng.integers(0, vocab, (batch, n_sparse)).astype(np.int32)
    dense = rng.standard_normal((batch, n_dense)).astype(np.float32)
    wide = rng.integers(0, 2 * vocab, (batch, n_crosses)).astype(np.int32)
    wide[rng.random(wide.shape) < 0.25] = -1
    # planted signal: click prob depends on parity of first sparse field
    logit = (sparse[:, 0] % 2) * 1.5 - 0.75 + 0.3 * dense[:, 0]
    labels = (rng.random(batch) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    return {"sparse_ids": sparse, "dense": dense, "wide_ids": wide,
            "labels": labels}


def batch_to_device(batch: dict, device=None) -> dict:
    """A ``recsys_batch`` as tensors on ``device`` (None means the card)."""
    device = resolve_device(device)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
