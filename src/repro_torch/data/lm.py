"""Synthetic LM token stream (the port of ``repro.data.lm``): Zipfian
unigrams with planted bigram structure.  Numpy, bit-equal to the
reference's."""

from __future__ import annotations

import numpy as np


def lm_batch(step: int, batch: int, seq: int, vocab: int, seed: int = 0):
    """Deterministic [batch, seq] int32 tokens for a given step."""
    rng = np.random.default_rng(seed * 1_000_003 + step)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -1.1
    p /= p.sum()
    toks = rng.choice(vocab, size=(batch, seq), p=p).astype(np.int32)
    # planted structure: token t is followed by (t*7+3)%vocab 50% of the time
    mask = rng.random((batch, seq - 1)) < 0.5
    nxt = (toks[:, :-1] * 7 + 3) % vocab
    toks[:, 1:] = np.where(mask, nxt, toks[:, 1:])
    return toks
