"""The port's Mixture-of-Experts FFN against the reference's: the
dispatch of one token group (``_dispatch_group``: the slots and the
sorted token ids equal as integers, the gates and the expert buffers
within float32 tolerance) at a tight capacity factor, where tokens are
dropped, and at an ample one; ``moe_ffn``'s output and aux loss; and the
dispatch against an explicit per-token loop (the reference's
``test_moe_dispatch_matches_dense_loop``).

Inputs are numpy from a seed; float32 rtol 1e-5 / atol 1e-5.  Random
float gates have no ties, so ``torch.topk`` and ``lax.top_k`` pick the
same experts in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import moe as RM

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.models import moe as TM


class Cfg:
    def __init__(self, capacity_factor, n_experts=8, moe_topk=2,
                 moe_renorm=True):
        self.n_experts = n_experts
        self.moe_topk = moe_topk
        self.capacity_factor = capacity_factor
        self.moe_renorm = moe_renorm
        self.moe_lb_coef = 0.01
        self.moe_z_coef = 1e-3


def _inputs(seed, t=48, d=16, e=8, f=24, w3=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    p = {"wg": rng.standard_normal((d, e)) * 0.5,
         "w1": rng.standard_normal((e, d, f)) * 0.2,
         "w2": rng.standard_normal((e, f, d)) * 0.2}
    if w3:
        p["w3"] = rng.standard_normal((e, d, f)) * 0.2
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return (jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
            torch.tensor(x), {k: torch.tensor(v) for k, v in p.items()})


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("cf,renorm", [(0.5, True), (8.0, True),
                                       (0.5, False)])
def test_dispatch_group(cf, renorm):
    cfg = Cfg(cf, moe_renorm=renorm)
    jx, jp, tx, tp = _inputs(0)
    t, k, e = 48, cfg.moe_topk, cfg.n_experts
    cap = max(4, min(int(cf * k * t / e), t * k))
    want_xe, (wslot, wst, wsw), wlb, wz = RM._dispatch_group(jx, jp, cfg,
                                                             cap)
    xe, (slot, st, sw), lb, z = TM._dispatch_group(tx, tp, cfg, cap)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(wslot))
    np.testing.assert_array_equal(st.numpy(), np.asarray(wst))
    dropped = int((slot == e * cap).sum())
    assert (dropped > 0) == (cf < 1)        # tight capacity drops tokens
    close(sw, wsw)
    close(xe, want_xe)
    close(lb, wlb)
    close(z, wz)


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("w3", [True, False])
def test_moe_ffn(cf, w3):
    cfg = Cfg(cf)
    jx, jp, tx, tp = _inputs(1, w3=w3)
    want, waux = RM.moe_ffn(jx, jp, cfg)
    got, aux = TM.moe_ffn(tx, tp, cfg)
    assert got.dtype == tx.dtype
    close(got, want)
    close(aux, waux)


def test_moe_ffn_in_bfloat16():
    """bfloat16 tokens and experts: within 1e-2 relative Frobenius of the
    reference's."""
    cfg = Cfg(1.25)
    jx, jp, tx, tp = _inputs(2)
    want, _ = RM.moe_ffn(jx.astype(jnp.bfloat16),
                         jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp),
                         cfg)
    got, _ = TM.moe_ffn(tx.bfloat16(),
                        {k: v.bfloat16() for k, v in tp.items()}, cfg)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
    assert err <= 1e-2, err


def test_dispatch_matches_dense_loop():
    """Ample capacity: the sorted dispatch equals an explicit loop over
    tokens and their top-2 experts."""
    cfg = Cfg(8.0, n_experts=4)
    _, _, x, p = _inputs(3, t=32, e=4)
    got, _ = TM.moe_ffn(x, p, cfg)
    gates = torch.softmax(x @ p["wg"], dim=-1)
    topw, topi = torch.topk(gates, 2, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True)
    want = torch.zeros_like(x)
    for ti in range(x.shape[0]):
        for kk in range(2):
            ei = int(topi[ti, kk])
            h = F.silu(x[ti] @ p["w1"][ei]) * (x[ti] @ p["w3"][ei])
            want[ti] += topw[ti, kk] * (h @ p["w2"][ei])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
