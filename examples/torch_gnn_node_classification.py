"""Train GAT on a synthetic cora-like citation graph (full-batch) and
verify accuracy beats the majority-class baseline.

The twin of ``examples/gnn_node_classification.py`` on ``repro_torch``:
the same graph, config, optimiser, learning rate and 120 steps.  Each
layer's message sum runs on the card's segment_sum kernel, and so does
the gradient of every gather (the plain versions with ``--device cpu``).
The weights are drawn from a seeded torch generator.

    PYTHONPATH=src python examples/torch_gnn_node_classification.py
    PYTHONPATH=src python examples/torch_gnn_node_classification.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.data.graphs import graph_to_device, synth_cora_like
from repro_torch.launch.cells import make_gnn_train_step
from repro_torch.models.gnn import models as gnn
from repro_torch.optim import AdamWConfig, adamw_init

STEPS = 120
PRINT_EVERY = 20


def setup(device=None, params=None):
    """(host graph, graph on ``device``, config, model, optimiser state,
    train step) as the example builds them; ``params`` (a tree in the
    reference's layout) replaces the seeded weights."""
    data = synth_cora_like(n_nodes=600, n_edges=3000, d_feat=64,
                           n_classes=5, seed=0)
    cfg = gnn.GNNConfig(arch="gat", n_layers=2, d_in=64, d_hidden=16,
                        n_heads=4, n_classes=5)
    g = graph_to_device(data, device)
    model = gnn.GAT(cfg, device=device, seed=0, params=params)
    ocfg = AdamWConfig(weight_decay=5e-4)
    opt = adamw_init(model.params(), ocfg)
    step = make_gnn_train_step(cfg, gnn.node_classification_loss, ocfg,
                               lr=5e-3)
    return data, g, cfg, model, opt, step


def main(argv=None):
    """Runs the example; returns the printed steps' losses (Python
    floats of the float32 losses) and the accuracies."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    data, g, cfg, model, opt, step = setup(args.device)
    losses = {}
    for i in range(STEPS):
        _, opt, loss, _ = step(model, opt, g)
        if i % PRINT_EVERY == 0:
            losses[i] = float(loss)
            print(f"step {i:3d} loss {losses[i]:.4f}")
    with torch.no_grad():
        logits = model(g)
    acc = float((logits.argmax(-1) == g["labels"]).float().mean())
    base = float(np.bincount(data["labels"]).max() / len(data["labels"]))
    print(f"train accuracy {acc:.3f} vs majority baseline {base:.3f}")
    assert acc > base + 0.15
    print("OK")
    return {"losses": losses, "accuracy": acc, "baseline": base}


if __name__ == "__main__":
    main()
