"""LM training in the port against the reference: ``make_lm_train_step``,
``loss_fn``'s gradient, ``launch.train.train_lm`` with its checkpoints,
and the three faults of the gradient path.

* One train step of each of the five LM ``smoke_config()``s, with and
  without microbatches (1, 2) and remat ("none", "full"), against the
  reference's jitted step from the same parameters
  (``params_from_numpy``), on the same tokens: loss, grad_norm, the AdamW
  state and every parameter, within ``test_torch_train._check_step``'s
  bounds (loss and grad_norm rtol 1e-5; moments within 1e-4 of each
  leaf's largest entry; parameters within lr·|Δstep| + 16 ulps).
* ``loss_fn``'s gradient against ``jax.grad``: each leaf within 1e-4 of
  its largest entry (float32 sums in another order).
* Fault 2: a stacked ``[L, ...]`` leaf's gradient makes one full-size
  tensor a backward (counted by a dispatch mode over
  ``torch.autograd.grad``), where indexing ``v[l]`` per layer made a
  zero-filled one per layer and an add.
* Fault 1: inside a train step's backward, on each recomputed layer and
  on a product's gradient, bf16 reduced-precision reductions are off
  (the flag reads and sets on CPU-only torch).
* Fault 3: the MoE forward traces on the meta device; its expert counts
  equal ``torch.bincount``'s.
* ``train_lm`` on the CPU against the reference's ``train_lm`` from the
  reference's initial parameters (the port's init patched), its losses
  within rtol 1e-4 over six steps; a run cut at step 4 and resumed from
  its checkpoint equals an uninterrupted one bit for bit; a checkpoint
  that the reference's ``train_lm`` wrote resumes in the port.
* ``examples/torch_train_lm.py --device cpu`` learns.
"""

import dataclasses
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.launch import cells as RCELLS
from repro.launch import train as RTRAIN
from repro.models import transformer as RT
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as ref_adamw_init

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.launch import train as TTRAIN
from repro_torch.launch.cells import make_lm_train_step
from repro_torch.models import transformer as TT
from repro_torch.models.common import params_from_numpy
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.tree import flatten
from test_torch_train import LR, _check_step

LM_ARCHS = ["deepseek_coder_33b", "qwen3_14b", "internlm2_20b",
            "arctic_480b", "grok1_314b"]
CPU = "cpu"


def _configs(name, **change):
    rc = importlib.import_module(f"repro.configs.{name}").smoke_config()
    tc = importlib.import_module(f"repro_torch.configs.{name}").smoke_config()
    return dataclasses.replace(rc, **change), dataclasses.replace(tc, **change)


def _tokens(vocab, b=4, s=16, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _lm(tc, params):
    return TT.LM(tc, device=CPU, params=params_from_numpy(
        jax.tree.map(np.asarray, params), device=CPU))


# --------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_train_step_matches_reference(name, microbatches, remat):
    rc, tc = _configs(name, remat=remat)
    params = RT.init(jax.random.PRNGKey(0), rc)
    tokens = _tokens(rc.vocab)
    rocfg, ocfg = RAdamWConfig(), AdamWConfig()
    rstep = jax.jit(RCELLS.make_lm_train_step(rc, rocfg, microbatches, LR))
    ref = rstep(params, ref_adamw_init(params, rocfg), jnp.asarray(tokens))
    model = _lm(tc, params)
    opt = adamw_init(model.params(), ocfg)
    step = make_lm_train_step(tc, ocfg, microbatches, LR)
    got_model, opt, loss, gnorm = step(model, opt, torch.as_tensor(tokens))
    assert got_model is model
    _check_step(ref, (model.params(), opt, loss, gnorm), ocfg,
                f"{name} mb={microbatches} remat={remat}")


def test_microbatch_accumulator_is_one_tree(monkeypatch):
    """The accumulator is allocated once a step (one zeros per leaf), and
    each part's gradient is added into it in place."""
    rc, tc = _configs("qwen3_14b")
    model = _lm(tc, RT.init(jax.random.PRNGKey(0), rc))
    n_leaves = len(flatten(model.params()))
    made = []
    real = torch.zeros

    def counting(*a, **k):
        out = real(*a, **k)
        made.append(tuple(out.shape))
        return out

    ocfg = AdamWConfig()
    opt = adamw_init(model.params(), ocfg)
    monkeypatch.setattr(torch, "zeros", counting)
    make_lm_train_step(tc, ocfg, 4, LR)(
        model, opt, torch.as_tensor(_tokens(rc.vocab, b=8)))
    monkeypatch.undo()
    leaf_shapes = sorted(tuple(p.shape) for p in flatten(model.params()))
    assert sorted(s for s in made if s in leaf_shapes
                  and len(s) > 0) == [s for s in leaf_shapes if len(s) > 0]
    assert n_leaves == len(leaf_shapes)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_loss_fn_gradient_matches_jax_grad(name):
    rc, tc = _configs(name, remat="full")
    params = RT.init(jax.random.PRNGKey(3), rc)
    tokens = _tokens(rc.vocab, b=2, s=32, seed=4)
    want = jax.jit(jax.grad(lambda p, t: RT.loss_fn(p, t, rc)[0]))(
        params, jnp.asarray(tokens))
    model = _lm(tc, params)
    loss, _ = TT.loss_fn(model.params(), torch.as_tensor(tokens), tc)
    got = torch.autograd.grad(loss, flatten(model.params()))
    for i, (g, w) in enumerate(zip(got, jax.tree.leaves(want))):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-30,
                                   err_msg=f"{name} leaf {i}")


# --------------------------------------------------------------------- #
# the three faults of the gradient path
# --------------------------------------------------------------------- #
class _ShapeCount(TorchDispatchMode):
    """Counts the tensors the ops return, by shape."""

    def __init__(self):
        super().__init__()
        self.count = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor):
                self.count[tuple(t.shape)] = self.count.get(
                    tuple(t.shape), 0) + 1
        return out


@pytest.mark.parametrize("remat", ["none", "full"])
def test_stacked_leaf_gradient_is_one_full_size_tensor(remat):
    """At L = 4 each stacked leaf's gradient is one full-size ``[L, ...]``
    tensor a backward (the unbind's ``stack``); per-layer indexing made a
    zero-filled ``[L, ...]`` tensor per layer and added it (14 of
    ``w1``'s shape with remat)."""
    rc, tc = _configs("qwen3_14b", n_layers=4, remat=remat)
    model = _lm(tc, RT.init(jax.random.PRNGKey(0), rc))
    leaves = flatten(model.params())
    loss, _ = TT.loss_fn(model.params(), torch.as_tensor(_tokens(rc.vocab)),
                         tc)
    counter = _ShapeCount()
    with counter:
        torch.autograd.grad(loss, leaves)
    stacked = [tuple(p.shape) for p in flatten(model.params()["layers"])]
    for shape in set(stacked):
        assert counter.count.get(shape, 0) <= stacked.count(shape), \
            (shape, counter.count.get(shape), stacked.count(shape))


def test_train_step_backward_reduces_in_float32(monkeypatch):
    """With the process flag on, a train step's recomputed layers and a
    product's gradient run with bf16 reduced-precision reductions off,
    and the flag is restored after the step."""
    rc, tc = _configs("qwen3_14b", remat="full")
    model = _lm(tc, RT.init(jax.random.PRNGKey(0), rc))
    mm = torch.backends.cuda.matmul
    flag = lambda: mm.allow_bf16_reduced_precision_reduction  # noqa: E731
    seen = {"layer": [], "grad": []}
    real_layer, real_ffn = TT._layer, TT._dense_ffn

    def layer(*a, **k):
        seen["layer"].append(flag())
        return real_layer(*a, **k)

    def ffn(x, p):
        h = x @ p["w1"]
        if h.requires_grad:
            h.register_hook(lambda g: seen["grad"].append(flag()))
        return torch.nn.functional.silu(h) * (x @ p["w3"]) @ p["w2"]

    monkeypatch.setattr(TT, "_layer", layer)
    monkeypatch.setattr(TT, "_dense_ffn", ffn)
    prev = flag()
    mm.allow_bf16_reduced_precision_reduction = True
    try:
        ocfg = AdamWConfig()
        make_lm_train_step(tc, ocfg, 1, LR)(
            model, adamw_init(model.params(), ocfg),
            torch.as_tensor(_tokens(rc.vocab)))
        after = flag()
    finally:
        mm.allow_bf16_reduced_precision_reduction = prev
    # each layer's forward and its recompute in the backward
    assert seen["layer"] == [False] * (2 * tc.n_layers)
    assert seen["grad"] and not any(seen["grad"])
    assert after is True


def test_moe_forward_traces_on_meta_and_counts_equal_bincount():
    """``moe_ffn`` runs on the meta device (``bincount`` has no meta
    kernel), and its expert counts equal ``bincount``'s on the CPU."""
    from repro_torch.models import moe as TM

    _, tc = _configs("arctic_480b")
    gen = torch.Generator().manual_seed(0)
    params = TT.init(gen, tc, device=CPU)
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.randn((40, tc.d_model), generator=gen)
    meta = {k: v.to("meta") for k, v in lp.items()}
    y, aux = TM.moe_ffn(x.to("meta"), meta, tc)
    assert y.device.type == "meta" and tuple(y.shape) == tuple(x.shape)
    assert aux.shape == ()

    seen = []
    real = torch.Tensor.index_add_

    def spy(self, dim, index, source, **kw):
        out = real(self, dim, index, source, **kw)
        if self.dtype == torch.long:
            seen.append((out.clone(), index.clone()))
        return out

    torch.Tensor.index_add_ = spy
    try:
        TM.moe_ffn(x, lp, tc)
    finally:
        torch.Tensor.index_add_ = real
    (counts, flat_e), = seen
    assert torch.equal(counts, torch.bincount(flat_e,
                                              minlength=tc.n_experts))


# --------------------------------------------------------------------- #
# train_lm: against the reference, crash and resume
# --------------------------------------------------------------------- #
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab=256, attn_chunk=16, remat="none")


def _tiny():
    return (RT.LMConfig(name="tiny", dtype=jnp.float32, **TINY),
            TT.LMConfig(name="tiny", dtype=torch.float32, **TINY))


def _reference_init(monkeypatch, rc, seed=0):
    """Patch the port's init to return the reference's parameters."""
    params = jax.tree.map(np.asarray, RT.init(jax.random.PRNGKey(seed), rc))
    monkeypatch.setattr(TT, "init", lambda gen, cfg, *, device=None:
                        params_from_numpy(params, device=device))


def test_train_lm_matches_reference(monkeypatch, tmp_path):
    rc, tc = _tiny()
    _reference_init(monkeypatch, rc)
    kw = dict(n_steps=6, batch=4, seq=16, log_every=1)
    _, want = RTRAIN.train_lm(rc, **kw)
    _, got = TTRAIN.train_lm(tc, **kw, device=CPU)
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(6))
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                               rtol=1e-4)
    assert got[-1][1] < got[0][1]


def test_train_lm_resumes_bit_for_bit(tmp_path):
    _, tc = _tiny()
    kw = dict(batch=4, seq=16, ckpt_every=2, log_every=1, device=CPU)
    whole, whole_losses = TTRAIN.train_lm(tc, 6,
                                          ckpt_dir=str(tmp_path / "a"), **kw)
    TTRAIN.train_lm(tc, 4, ckpt_dir=str(tmp_path / "b"), **kw)   # the crash
    resumed, resumed_losses = TTRAIN.train_lm(
        tc, 6, ckpt_dir=str(tmp_path / "b"), **kw)
    assert [i for i, _ in resumed_losses] == [4, 5]
    assert resumed_losses == whole_losses[4:]
    for a, b in zip(flatten(resumed), flatten(whole)):
        assert torch.equal(a, b)


def test_train_lm_resumes_a_reference_checkpoint(monkeypatch, tmp_path):
    """The reference's train_lm writes steps 2 and 4; the port resumes at
    4 and takes steps 4 and 5 as the reference's own resume does."""
    rc, tc = _tiny()
    _reference_init(monkeypatch, rc)
    kw = dict(batch=4, seq=16, ckpt_every=2, log_every=1)
    RTRAIN.train_lm(rc, 4, ckpt_dir=str(tmp_path), **kw)
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    for f in tmp_path.glob("step_*"):
        (ref_dir / f.name).write_bytes(f.read_bytes())
    _, want = RTRAIN.train_lm(rc, 6, ckpt_dir=str(ref_dir), **kw)
    _, got = TTRAIN.train_lm(tc, 6, ckpt_dir=str(tmp_path), **kw,
                             device=CPU)
    assert [i for i, _ in got] == [i for i, _ in want] == [4, 5]
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                               rtol=1e-5)


def test_restore_writes_into_the_module(tmp_path):
    """A resume copies into the module's own parameters and the state's
    tensors: the objects the step holds are the ones restored."""
    _, tc = _tiny()
    kw = dict(batch=4, seq=16, ckpt_every=2, log_every=1, device=CPU)
    TTRAIN.train_lm(tc, 2, ckpt_dir=str(tmp_path), **kw)
    model = TT.LM(tc, device=CPU, seed=0)
    opt = adamw_init(model.params(), AdamWConfig())
    ids = [id(t) for t in flatten({"p": model.params(), "o": opt})]
    TTRAIN._restore_into({"p": model.params(), "o": opt}, str(tmp_path), 2)
    assert [id(t) for t in flatten({"p": model.params(), "o": opt})] == ids
    assert int(opt["count"]) == 2
    fresh = TT.LM(tc, device=CPU, seed=0)
    assert not torch.equal(model.embed, fresh.embed)


def test_example_learns_on_the_cpu(capsys):
    path = Path(__file__).resolve().parents[1] / "examples" \
        / "torch_train_lm.py"
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    losses = mod.main(["--device", "cpu", "--steps", "60"])
    assert "OK: loss dropped" in capsys.readouterr().out
    assert losses[-1][1] < 0.8 * losses[0][1]

