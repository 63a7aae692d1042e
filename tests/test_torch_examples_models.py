"""The port's model examples against the JAX package's, on the CPU.

``examples/torch_gnn_node_classification.py`` and
``torch_serve_recsys.py`` run whole with ``--device cpu`` (120 GAT steps
to an accuracy 0.15 over the majority class; 150 Wide&Deep steps to a
held-out AUC over 0.6, and a retrieval), as their JAX twins assert.
Their first train step is then held to the JAX example's step from the
same weights (the reference's ``gat_init`` / ``wide_deep.init`` carried
across by ``params_from_numpy``): the loss within float32 summation
noise, rtol 1e-5."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.models.common import params_from_numpy

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
CPU = "cpu"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _carried(params):
    return params_from_numpy(jax.tree.map(np.asarray, params), device=CPU)


def test_gnn_example_trains_and_steps_as_the_jax_example(capsys):
    from repro.launch.cells import make_gnn_train_step
    from repro.models.gnn import models as gnn
    from repro.optim import AdamWConfig, adamw_init

    port = _load("torch_gnn_node_classification")
    res = port.main(["--device", "cpu"])
    assert res["accuracy"] > res["baseline"] + 0.15
    assert sorted(res["losses"]) == list(range(0, 120, 20))
    assert "OK" in capsys.readouterr().out
    # the JAX example's first step, and the port's from its weights
    ref = _load("gnn_node_classification")
    data = ref.synth_cora_like(n_nodes=600, n_edges=3000, d_feat=64,
                               n_classes=5, seed=0)
    cfg = gnn.GNNConfig(arch="gat", n_layers=2, d_in=64, d_hidden=16,
                        n_heads=4, n_classes=5)
    params = gnn.gat_init(jax.random.PRNGKey(0), cfg)
    ocfg = AdamWConfig(weight_decay=5e-4)
    step = jax.jit(make_gnn_train_step(
        cfg, lambda p, gg, c: gnn.node_classification_loss(p, gg, c),
        ocfg, lr=5e-3))
    _, _, want, _ = step(params, adamw_init(params, ocfg),
                         {k: jnp.asarray(v) for k, v in data.items()})
    pdata, g, _, model, opt, pstep = port.setup(CPU, _carried(params))
    for k, v in data.items():
        np.testing.assert_array_equal(pdata[k], v)
    _, _, got, _ = pstep(model, opt, g)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_recsys_example_trains_and_steps_as_the_jax_example(capsys):
    from repro.configs.wide_deep import smoke_config
    from repro.data.recsys import recsys_batch
    from repro.launch.cells import make_recsys_train_step
    from repro.models.recsys import wide_deep as wd
    from repro.optim import AdamWConfig, adamw_init

    port = _load("torch_serve_recsys")
    res = port.main(["--device", "cpu"])
    assert res["auc"] > 0.6 and 0 <= res["top1"][1] < 5000
    assert sorted(res["losses"]) == list(range(0, 150, 30))
    assert "OK" in capsys.readouterr().out
    cfg = smoke_config()
    params = wd.init(jax.random.PRNGKey(0), cfg)
    ocfg = AdamWConfig(state_mode="factored")
    step = jax.jit(make_recsys_train_step(cfg, ocfg, lr=3e-3))
    b = {k: jnp.asarray(v) for k, v in recsys_batch(
        0, 256, cfg.n_sparse, cfg.vocab_per_field, cfg.n_dense,
        cfg.n_wide_crosses).items()}
    _, _, want, _ = step(params, adamw_init(params, ocfg), b)
    pcfg, model, opt, pstep = port.setup(CPU, _carried(params))
    _, _, got, _ = pstep(model, opt, port.batch(pcfg, 0, 256, CPU))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
