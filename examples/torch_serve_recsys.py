"""Wide&Deep CTR serving example: train briefly on the planted-signal
synthetic CTR stream, then run batched online inference + retrieval.

The twin of ``examples/serve_recsys.py`` on ``repro_torch``: the same
smoke config, batches, optimiser and 150 steps.  The wide part's bags
run on the card's embedding_bag kernel and their gradient on its
segment_sum kernel (the plain versions with ``--device cpu``).  The
weights and the retrieval candidates are drawn from seeded torch
generators.

    PYTHONPATH=src python examples/torch_serve_recsys.py
    PYTHONPATH=src python examples/torch_serve_recsys.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.configs.wide_deep import smoke_config
from repro_torch.data.recsys import batch_to_device, recsys_batch
from repro_torch.launch.cells import make_recsys_train_step
from repro_torch.models.recsys import wide_deep as wd
from repro_torch.optim import AdamWConfig, adamw_init

STEPS = 150
PRINT_EVERY = 30


def batch(cfg, step: int, size: int, device=None) -> dict:
    return batch_to_device(recsys_batch(
        step, size, cfg.n_sparse, cfg.vocab_per_field, cfg.n_dense,
        cfg.n_wide_crosses), device)


def setup(device=None, params=None):
    """(config, model, optimiser state, train step) as the example
    builds them; ``params`` (a tree in the reference's layout) replaces
    the seeded weights."""
    cfg = smoke_config()
    model = wd.WideDeep(cfg, device=device, seed=0, params=params)
    ocfg = AdamWConfig(state_mode="factored")
    opt = adamw_init(model.params(), ocfg)
    step = make_recsys_train_step(cfg, ocfg, lr=3e-3)
    return cfg, model, opt, step


def main(argv=None):
    """Runs the example; returns the printed steps' losses, the held-out
    AUC and the retrieval's top-1."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = args.device
    cfg, model, opt, step = setup(dev)
    losses = {}
    for i in range(STEPS):
        _, opt, loss, _ = step(model, opt, batch(cfg, i, 256, dev))
        if i % PRINT_EVERY == 0:
            losses[i] = float(loss)
            print(f"step {i:3d} bce {losses[i]:.4f}")

    # online inference: AUC-ish sanity on held-out batch
    b = batch(cfg, 10_000, 2048, dev)
    with torch.no_grad():
        scores = model(b).float().cpu().numpy()
    y = b["labels"].cpu().numpy()
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(len(scores))
    n1, n0 = y.sum(), (1 - y).sum()
    auc = (ranks[y == 1].sum() - n1 * (n1 - 1) / 2) / (n1 * n0)
    print(f"held-out AUC {auc:.3f}")
    assert auc > 0.6, "planted CTR signal not learned"

    # retrieval: top-k against a candidate table
    gen = torch.Generator(device=model.head.device).manual_seed(2)
    cands = torch.randn((5000, cfg.embed_dim), generator=gen,
                        device=model.head.device)
    user = torch.randn((cfg.embed_dim,), generator=gen,
                       device=model.head.device)
    vals, idx = wd.retrieval_score(user, cands, top_k=10)
    print(f"retrieval top-1 score {float(vals[0]):.3f} @ cand {int(idx[0])}")
    print("OK")
    return {"losses": losses, "auc": float(auc),
            "top1": (float(vals[0]), int(idx[0]))}


if __name__ == "__main__":
    main()
