"""The port's Wide&Deep serving path against the reference's.

``recsys_batch`` must give the reference's arrays bit for bit.  The
reference's initial parameters (``wd.init`` of the smoke config) carry
across with ``params_from_numpy``; the port's forward (its embedding_bag
on the CPU is the plain version) is held to the reference forward with
its Pallas kernel in interpret mode, rtol 1e-5 / atol 1e-5 (float32
sums and products in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import wide_deep as ref_cfg
from repro.data.recsys import recsys_batch as ref_batch
from repro.models.recsys import wide_deep as RWD

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.configs import wide_deep as port_cfg
from repro_torch.data.recsys import batch_to_device, recsys_batch
from repro_torch.models.recsys import wide_deep as WD


@pytest.mark.parametrize("step,seed", [(0, 0), (3, 0), (5, 2)])
def test_recsys_batch_is_bit_equal(step, seed):
    args = (step, 64, 7, 1000, 5, 9)
    want = ref_batch(*args, seed=seed)
    got = recsys_batch(*args, seed=seed)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype
        assert np.array_equal(want[k], got[k]), k


def _models():
    rcfg = dataclasses.replace(ref_cfg.smoke_config(),
                               backend="pallas_interpret")
    params = RWD.init(jax.random.PRNGKey(0), rcfg)
    tree = jax.tree.map(np.asarray, params)
    pcfg = port_cfg.smoke_config()
    model = WD.WideDeep(pcfg, device="cpu",
                        params=WD.params_from_numpy(tree, device="cpu"))
    return rcfg, params, pcfg, model


def _batch(cfg, step, b=16):
    return recsys_batch(step, b, cfg.n_sparse, cfg.vocab_per_field,
                        cfg.n_dense, cfg.n_wide_crosses, seed=1)


def test_config_matches_reference():
    for name in ("n_sparse", "vocab_per_field", "embed_dim", "n_dense",
                 "mlp", "wide_vocab", "n_wide_crosses"):
        assert getattr(ref_cfg.CONFIG, name) == getattr(port_cfg.CONFIG, name)
        assert getattr(ref_cfg.smoke_config(), name) == \
            getattr(port_cfg.smoke_config(), name)


@pytest.mark.parametrize("step", [0, 1])
def test_forward_and_loss_match_reference(step):
    rcfg, params, pcfg, model = _models()
    nb = _batch(pcfg, step)
    assert (nb["wide_ids"] == -1).any()
    want = np.asarray(RWD.forward(params, {k: jnp.asarray(v)
                                           for k, v in nb.items()}, rcfg))
    tb = batch_to_device(nb, device="cpu")
    with torch.no_grad():
        got = model(tb)
        loss, aux = WD.bce_loss(model, tb)
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    want_loss, _ = RWD.bce_loss(params, {k: jnp.asarray(v)
                                         for k, v in nb.items()}, rcfg)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5,
                               atol=1e-6)
    assert aux["bce"] is loss


def test_seeded_init_has_the_reference_shapes():
    _, params, pcfg, _ = _models()
    mine = WD.WideDeep(pcfg, device="cpu", seed=3)
    ref_shapes = [tuple(x.shape) for x in jax.tree.leaves(params)]
    assert sorted(ref_shapes) == sorted(tuple(p.shape)
                                        for p in mine.parameters())


def test_retrieval_topk_matches_reference():
    rng = np.random.default_rng(2)
    cands = rng.standard_normal((1000, 16)).astype(np.float32)
    u = rng.standard_normal(16).astype(np.float32)
    wv, wi = RWD.retrieval_score(jnp.asarray(u), jnp.asarray(cands), 10)
    gv, gi = WD.retrieval_score(torch.as_tensor(u), torch.as_tensor(cands),
                                10)
    assert np.array_equal(np.asarray(wi), gi.numpy())
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5,
                               atol=1e-5)
