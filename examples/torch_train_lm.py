"""End-to-end driver of the PyTorch port: train an LM for a few hundred
steps on the synthetic planted-bigram corpus and check that the loss
drops well below where it started (the model must learn the planted
structure, not just frequencies).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
        [--profile small|10m|100m] [--device cpu]

The profiles are ``examples/train_lm.py``'s; ``--device`` defaults to
the card (there is no CPU fallback).  Checkpoints go to a temporary
directory every 100 steps (``launch.train.train_lm``).
"""

import argparse
import tempfile

import torch

from repro_torch.launch.train import train_lm
from repro_torch.models.transformer import LMConfig

PROFILES = {
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 head_dim=64, d_ff=2048, vocab=8192, batch=32, seq=256),
    "10m": dict(n_layers=6, d_model=320, n_heads=8, n_kv_heads=4,
                head_dim=40, d_ff=1024, vocab=2048, batch=16, seq=128),
    "small": dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                  head_dim=32, d_ff=384, vocab=512, batch=16, seq=64),
}


def profile_config(name: str):
    """(config, batch, seq) of a profile: float32, one attention chunk,
    no remat, as the reference's example."""
    p = dict(PROFILES[name])
    batch, seq = p.pop("batch"), p.pop("seq")
    cfg = LMConfig(name=f"lm-{name}", dtype=torch.float32, attn_chunk=seq,
                   remat="none", **p)
    return cfg, batch, seq


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--profile", default="small", choices=PROFILES)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    cfg, batch, seq = profile_config(args.profile)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        _, losses = train_lm(
            cfg, n_steps=args.steps, batch=batch, seq=seq,
            ckpt_dir=ckpt_dir, ckpt_every=100, log_every=20,
            device=args.device)
    first, last = losses[0][1], losses[-1][1]
    print(f"loss: {first:.3f} -> {last:.3f}")
    if not last < first * 0.8:
        raise SystemExit("model failed to learn planted structure")
    print("OK: loss dropped; planted bigram structure learned")
    return losses


if __name__ == "__main__":
    main()
