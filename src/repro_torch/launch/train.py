"""Training driver for the LM family (the port of ``repro.launch.train``).

Wires together: config -> ``LM`` module -> ``make_lm_train_step`` ->
``data.lm.lm_batch`` -> ``AsyncCheckpointer`` (checkpoints, and a resume
from the newest one).  On one card this trains the reduced configs end to
end (``examples/torch_train_lm.py``).

    python -m repro_torch.launch.train [--steps N] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
)
from repro_torch.core.state import resolve_device
from repro_torch.data.lm import lm_batch
from repro_torch.launch.cells import make_lm_train_step
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.tree import flatten


@torch.no_grad()
def _restore_into(tree, ckpt_dir: str, step: int) -> None:
    """Checkpoint ``step`` written into ``tree``'s own tensors (the
    module's parameters, the optimiser state), in place."""
    for dst, src in zip(flatten(tree),
                        flatten(restore_checkpoint(ckpt_dir, step, tree))):
        dst.copy_(src)


def train_lm(
    cfg: tfm.LMConfig,
    n_steps: int = 200,
    batch: int = 8,
    seq: int = 64,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    log_every: int = 10,
    microbatches: int = 1,
    seed: int = 0,
    *,
    device=None,
):
    """Train a (reduced) LM on ``device`` (None means the card); returns
    (params, list of (step, loss)).  With ``ckpt_dir`` it checkpoints
    ``{"p": params, "o": opt}`` every ``ckpt_every`` steps and resumes
    from the newest checkpoint there."""
    device = resolve_device(device)
    ocfg = AdamWConfig()
    model = tfm.LM(cfg, device=device, seed=seed)
    opt = adamw_init(model.params(), ocfg)
    step_fn = make_lm_train_step(cfg, ocfg, microbatches, lr=3e-4)
    state = {"p": model.params(), "o": opt}

    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt_dir and (last := latest_step(ckpt_dir)) is not None:
        _restore_into(state, ckpt_dir, last)
        start = last

    losses = []
    for i in range(start, n_steps):
        toks = torch.as_tensor(lm_batch(i, batch, seq, cfg.vocab, seed),
                               device=device)
        _, opt, loss, gnorm = step_fn(model, opt, toks)
        if i % log_every == 0 or i == n_steps - 1:
            losses.append((i, float(loss)))
            print(f"step {i:5d}  loss {float(loss):.4f}  "
                  f"gnorm {float(gnorm):.3f}", flush=True)
        if ckpt and (i + 1) % ckpt_every == 0:
            ckpt.save(i + 1, state)
    if ckpt:
        ckpt.wait()
    return model.params(), losses


def main(*, argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    cfg = tfm.LMConfig(
        name="driver-lm", n_layers=args.layers, d_model=args.d_model,
        n_heads=max(4, args.d_model // 64), n_kv_heads=2,
        head_dim=min(64, args.d_model // 4), d_ff=args.d_model * 4,
        vocab=args.vocab, dtype=torch.float32, attn_chunk=args.seq,
        remat="none")
    train_lm(cfg, n_steps=args.steps, batch=args.batch, seq=args.seq,
             ckpt_dir=args.ckpt_dir, device=args.device)


if __name__ == "__main__":
    main()
