"""Train steps of the substrate models: the port of the step builders of
``repro.launch.cells`` (``make_gnn_train_step``,
``make_recsys_train_step``), and the LM cells' parameter count
(``lm_param_flops``).

A step takes the model (an ``nn.Module`` that holds its parameters and
config), the optimiser state (``optim.adamw_init`` of
``model.params()``) and a batch: it runs the forward and the backward
(``torch.autograd.grad``, so no ``.grad`` is left on the parameters),
then ``adamw_update``, which writes the new parameters into the module
in place.  It returns ``(model, opt_state, loss, grad_norm)``.  ``lr``
is the builder's value, captured by the step as in the reference.  The
reference's cells (``Cell``, ``build_cell``, the LM cells and their
shardings) and ``make_lm_train_step`` are not ported here.
"""

from __future__ import annotations

import torch

from repro_torch.models.recsys import wide_deep as wd
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.tree import flatten, unflatten


def _step(model, opt_state, loss, lr, ocfg: AdamWConfig):
    params = model.params()
    leaves = flatten(params)
    l, _ = loss()
    # a parameter the loss does not reach (NequIP's last gate) has a zero
    # gradient, as jax.grad gives it
    grads = torch.autograd.grad(l, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    _, opt_state, st = adamw_update(unflatten(params, grads), opt_state,
                                    params, lr, ocfg)
    return model, opt_state, l.detach(), st["grad_norm"]


def make_gnn_train_step(cfg, loss, ocfg: AdamWConfig, lr: float = 1e-3):
    """``train_step(model, opt_state, g)`` for a GNN or NequIP module.
    ``loss(model, g)`` -> (loss, aux): ``models.node_classification_loss``,
    or for NequIP ``lambda m, g: nequip.mse_loss(m.params(), g, m.cfg)``.
    ``cfg`` is the model's config, in the reference's first slot: the
    port's losses read it from the module."""
    del cfg

    def train_step(model, opt_state, g):
        return _step(model, opt_state, lambda: loss(model, g), lr, ocfg)

    return train_step


def make_recsys_train_step(cfg, ocfg: AdamWConfig, lr: float = 1e-3):
    """``train_step(model, opt_state, batch)`` for a ``WideDeep`` module
    on ``wide_deep.bce_loss``; ``cfg`` as in ``make_gnn_train_step``."""
    del cfg

    def train_step(model, opt_state, batch):
        return _step(model, opt_state, lambda: wd.bce_loss(model, batch),
                     lr, ocfg)

    return train_step


def lm_param_flops(cfg) -> tuple[int, int]:
    """(total params, active params) — MoE counts top-k experts only."""
    d, f, L, v = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab
    attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim \
        + cfg.n_heads * cfg.head_dim * d
    if cfg.moe:
        ffn_total = cfg.n_experts * 3 * d * f + d * cfg.n_experts
        ffn_active = cfg.moe_topk * 3 * d * f + d * cfg.n_experts
        if cfg.dense_residual:
            rf = cfg.residual_d_ff or f
            ffn_total += 3 * d * rf
            ffn_active += 3 * d * rf
    else:
        ffn_total = ffn_active = 3 * d * f
    total = L * (attn + ffn_total) + 2 * v * d
    active = L * (attn + ffn_active) + 2 * v * d
    return total, active
