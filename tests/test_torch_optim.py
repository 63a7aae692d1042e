"""The port's optimiser (``repro_torch.optim``) against ``repro.optim``.

The same numpy inputs go through both packages on the CPU.

* ``adamw_update`` in each state mode over one tree that has a stacked
  3-D leaf (updated slice by slice, per-slice int8 scales), a factored
  2-D leaf, a small 2-D leaf (not factored: a side under 8) and a 1-D
  leaf (no weight decay), for several steps under a cosine schedule.
  Tolerance, per step: parameters rtol 1e-5 / atol 1e-6, float state
  rtol 1e-5 / atol 1e-5 of the leaf's largest magnitude.  Both sides
  compute in float32; the global norm and the factored row and column
  means sum in another order (a few ulp), the update carries that into
  the parameters scaled by lr, and a moment's ``b m + (1 - b) g``
  cancels where the two terms nearly meet, so its error is relative to
  the leaf's scale, not to the entry.
  int8 first moments: a difference of one ulp in ``m / s`` can flip a
  rounding, so ``m_q`` may differ by one quantum, on at most 1% of the
  entries, and by no more anywhere.
* The ports of ``test_substrate.py``'s optimiser tests: convergence in
  each mode, the factored state's size, the schedule, quantisation with
  error feedback.
* ``compressed_psum`` against the reference's under ``shard_map`` over 4
  virtual CPU devices, run in a subprocess (the device count must be set
  before JAX starts): the port holds the shard axis as each leaf's
  leading axis.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro.optim import compress as RC
from repro.optim import schedule as RS

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, \
    cosine_with_warmup
from repro_torch.optim import compress as TC
from repro_torch.optim.tree import flatten

ROOT = Path(__file__).resolve().parents[1]
TOL_P = dict(rtol=1e-5, atol=1e-6)
MODES = ["fp32", "factored", "int8"]


def _tree(rng):
    return {"stack": rng.standard_normal((3, 16, 12)).astype(np.float32),
            "fact": rng.standard_normal((10, 9)).astype(np.float32),
            "small": rng.standard_normal((4, 5)).astype(np.float32),
            "vec": rng.standard_normal((7,)).astype(np.float32)}


def _assert_state(ref_leaves, port_leaves, where):
    for k in ref_leaves:
        for sk, r in ref_leaves[k].items():
            r = np.asarray(r)
            t = port_leaves[k][sk].numpy()
            assert r.shape == t.shape and r.dtype == t.dtype, (where, k, sk)
            if sk == "m_q":
                d = np.abs(r.astype(np.int32) - t.astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() <= 0.01, \
                    (where, k, int(d.max()), float((d > 0).mean()))
            else:
                np.testing.assert_allclose(
                    t, r, rtol=1e-5, atol=1e-5 * float(np.abs(r).max()),
                    err_msg=f"{where} {k}.{sk}")


@pytest.mark.parametrize("mode", MODES)
def test_adamw_update_equals_reference(mode):
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    rcfg = RA.AdamWConfig(state_mode=mode, clip_norm=5.0)
    tcfg = AdamWConfig(state_mode=mode, clip_norm=5.0)
    rlr = RS.cosine_with_warmup(1e-2, warmup=2, total=6)
    tlr = cosine_with_warmup(1e-2, warmup=2, total=6)
    rp = {k: jnp.asarray(v) for k, v in tree.items()}
    tp = {k: torch.tensor(v) for k, v in tree.items()}
    rs, ts = RA.adamw_init(rp, rcfg), adamw_init(tp, tcfg)
    _assert_state(rs["leaves"], ts["leaves"], "init")
    for step in range(6):
        # the first steps' norms exceed clip_norm, the later ones do not
        g = {k: (rng.standard_normal(v.shape) * (2.0 if step < 3 else 0.1))
             .astype(np.float32) for k, v in tree.items()}
        rp, rs, rst = RA.adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                      rs, rp, rlr(step), rcfg)
        out_p, ts, tst = adamw_update({k: torch.tensor(v) for k, v in g.items()},
                                      ts, tp, tlr(step), tcfg)
        assert out_p is tp                      # written in place
        np.testing.assert_allclose(float(tst["grad_norm"]),
                                   float(rst["grad_norm"]), rtol=1e-6)
        for k in tree:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                       **TOL_P, err_msg=f"step {step} {k}")
        _assert_state(rs["leaves"], ts["leaves"], f"step {step}")
        assert int(ts["count"]) == int(rs["count"]) == step + 1


@pytest.mark.parametrize("mode", MODES)
def test_stacked_leaf_chunks_give_the_same_update(mode, monkeypatch):
    """A stacked leaf's update runs a chunk of whole slices at a time
    (``_CHUNK_ELEMS``); one slice a chunk, two, or the whole leaf give the
    same parameters and state, bit for bit (every reduction is per
    slice)."""
    from repro_torch.optim import adamw as TA

    rng = np.random.default_rng(4)
    p0 = rng.standard_normal((5, 16, 12)).astype(np.float32)
    grads = [rng.standard_normal(p0.shape).astype(np.float32)
             for _ in range(3)]
    cfg = AdamWConfig(state_mode=mode)
    runs = []
    for chunk in (16 * 12, 2 * 16 * 12, 1 << 25):
        monkeypatch.setattr(TA, "_CHUNK_ELEMS", chunk)
        p = {"w": torch.tensor(p0)}
        st = adamw_init(p, cfg)
        for g in grads:
            adamw_update({"w": torch.tensor(g)}, st, p, 1e-2, cfg)
        runs.append([p["w"]] + flatten(st))
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


def test_update_leaves_no_reference_cycle():
    """A step's gradients are freed when the caller drops them, without
    waiting for the garbage collector (a recursive closure in the tree
    code once held them in a cycle: 4.77 GiB a Wide&Deep step)."""
    import gc
    import weakref

    from repro_torch.optim.tree import unflatten

    gc.disable()
    try:
        p = {"a": torch.zeros((3, 16, 12)), "b": [torch.zeros(5)]}
        st = adamw_init(p, AdamWConfig())
        grads = [torch.ones((3, 16, 12)), torch.ones(5)]
        refs = [weakref.ref(g) for g in grads]
        adamw_update(unflatten(p, grads), st, p, 1e-3, AdamWConfig())
        del grads
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_stacked_int8_scale_is_per_slice():
    p = {"stack": torch.zeros((3, 16, 12)), "fact": torch.zeros((10, 9))}
    st = adamw_init(p, AdamWConfig(state_mode="int8"))
    assert st["leaves"]["stack"]["m_scale"].shape == (3,)
    assert st["leaves"]["fact"]["m_scale"].shape == ()
    assert st["leaves"]["stack"]["vr"].shape == (3, 16)
    assert st["leaves"]["stack"]["vc"].shape == (3, 12)


def toy_problem():
    rng = np.random.default_rng(0)
    w_true = torch.tensor(rng.standard_normal((8, 4)).astype(np.float32))
    x = torch.tensor(rng.standard_normal((64, 8)).astype(np.float32))
    y = x @ w_true

    def loss(params):
        pred = x @ params["w"] + params["b"]
        return torch.mean((pred - y) ** 2)

    return loss, {"w": torch.zeros((8, 4)), "b": torch.zeros((4,))}


@pytest.mark.parametrize("mode", MODES)
def test_adamw_modes_converge(mode):
    loss, params = toy_problem()
    cfg = AdamWConfig(state_mode=mode, weight_decay=0.0)
    state = adamw_init(params, cfg)
    l0 = float(loss(params))
    for _ in range(150):
        leaves = [p.requires_grad_() for p in flatten(params)]
        grads = torch.autograd.grad(loss(params), leaves)
        params = {"b": params["b"].detach(), "w": params["w"].detach()}
        params, state, _ = adamw_update(
            {"b": grads[0], "w": grads[1]}, state, params, 0.05, cfg)
    l1 = float(loss(params))
    assert l1 < l0 * 0.05, (l0, l1)


def test_factored_state_is_smaller():
    big = {"w": torch.zeros((256, 128))}
    full = adamw_init(big, AdamWConfig(state_mode="fp32"))
    fact = adamw_init(big, AdamWConfig(state_mode="factored"))

    def size(t):
        return sum(x.numel() * x.element_size() for x in flatten(t))

    assert size(fact) < size(full) * 0.6


def test_schedule():
    lr = cosine_with_warmup(1e-3, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1e-3) < 1e-9
    assert float(lr(100)) < float(lr(50)) < float(lr(10))
    ref = RS.cosine_with_warmup(1e-3, warmup=10, total=100)
    for step in (0, 3, 10, 11, 37, 64, 100, 140):
        assert lr(step).dtype == torch.float32
        np.testing.assert_allclose(float(lr(step)), float(ref(step)),
                                   rtol=1e-6, err_msg=str(step))


def _residuals_agree(got, want, d, s):
    """Error-feedback residuals of the port (``got``) and the reference
    (``want``), where ``d`` is the port's int8 value less the reference's
    and ``s`` the scale (broadcast).  Where the int8 values agree the
    residuals agree to float32 rounding; where one flipped by a quantum
    (one ulp of ``x / s`` across packages) the residual is ``x - q * s``,
    so the port's is the reference's less exactly ``d * s``."""
    assert np.abs(d).max() <= 1
    s = np.broadcast_to(s, got.shape)
    np.testing.assert_allclose(got[d == 0], want[d == 0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose((got - want)[d != 0], (-d * s)[d != 0],
                               rtol=1e-5, atol=1e-6)


def test_quantize_error_feedback():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    g = {"w": torch.tensor(w)}
    q, s, res = TC.quantize_tree(g)
    deq = TC.dequantize_tree(q, s)
    err = float((deq["w"] - g["w"]).abs().max())
    scale = float(s["w"])
    assert err <= scale * 0.5 + 1e-6
    # residual carries exactly the quantization error
    np.testing.assert_allclose(res["w"].numpy(), (g["w"] - deq["w"]).numpy(),
                               rtol=1e-5, atol=1e-6)
    # int8 payload is 4x smaller than fp32
    assert q["w"].dtype == torch.int8
    # the reference's quantisation, with a residual carried in
    r0 = rng.standard_normal((64, 64)).astype(np.float32) * 1e-2
    rq, rs_, rr = RC.quantize_tree({"w": jnp.asarray(w)},
                                   {"w": jnp.asarray(r0)})
    tq, ts_, tr = TC.quantize_tree(g, {"w": torch.tensor(r0)})
    d = (tq["w"].numpy().astype(np.int32)
         - np.asarray(rq["w"]).astype(np.int32))
    assert np.abs(d).max() <= 1 and (d != 0).mean() <= 0.01
    np.testing.assert_allclose(float(ts_["w"]), float(rs_["w"]), rtol=1e-6)
    _residuals_agree(tr["w"].numpy(), np.asarray(rr["w"]), d,
                     np.float32(rs_["w"]))


_PSUM_REF = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.core.compat import shard_map, shard_map_compat_kwargs
    from repro.optim.compress import compressed_psum

    data = np.load(sys.argv[1])
    mesh = jax.make_mesh((4,), ("data",))
    spec = {"a": P("data"), "b": P("data")}
    f = jax.jit(shard_map(
        lambda g, r: compressed_psum(g, "data", r), mesh=mesh,
        in_specs=(spec, spec), out_specs=(spec, spec),
        **shard_map_compat_kwargs()))
    res = {"a": np.zeros_like(data["a0"]), "b": np.zeros_like(data["b0"])}
    out = {}
    for step in range(2):
        g = {"a": data[f"a{step}"], "b": data[f"b{step}"]}
        mean, res = f(g, res)
        for k in ("a", "b"):
            out[f"mean_{k}{step}"] = np.asarray(mean[k])
            out[f"res_{k}{step}"] = np.asarray(res[k])
    np.savez(sys.argv[2], **out)
""")


def test_compressed_psum_equals_reference_under_shard_map(tmp_path):
    rng = np.random.default_rng(5)
    data = {}
    for step in range(2):
        # shard 2's values are larger: the shared scale is its scale
        scale = np.array([1.0, 0.5, 3.0, 1.0], np.float32)
        data[f"a{step}"] = (rng.standard_normal((4, 6, 5)).astype(np.float32)
                            * scale[:, None, None])
        data[f"b{step}"] = rng.standard_normal((4, 8)).astype(np.float32)
    np.savez(tmp_path / "in.npz", **data)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _PSUM_REF, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = np.load(tmp_path / "out.npz")
    for step in range(2):
        g = {k: torch.tensor(data[f"{k}{step}"]) for k in ("a", "b")}
        # the reference's residual carried in, so both sides quantize the
        # same x (step 0 already holds the port's residual to it)
        carried = ({k: torch.tensor(ref[f"res_{k}{step - 1}"])
                    for k in ("a", "b")} if step else None)
        mean, res = TC.compressed_psum(g, "data", carried)
        for k in ("a", "b"):
            want = ref[f"mean_{k}{step}"]
            got = mean[k].numpy()
            assert got.shape == want.shape
            assert (got == got[:1]).all()      # every shard the same mean
            # each shard's scale, and the shared (largest) one
            x = data[f"{k}{step}"] + (ref[f"res_{k}{step - 1}"] if step
                                      else 0)
            s = np.abs(x.reshape(4, -1)).max(1) / 127
            # a rounding flipped by one ulp of x / s moves one shard's
            # int8 value by one: the mean by s_max / 4, that shard's
            # residual by its own s
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=s.max() / 4 * 1.01)
            flips = ~np.isclose(got, want, rtol=1e-5, atol=0)
            assert flips.mean() <= 0.05
            # each shard's int8 value, read back from its residual
            s = s.astype(np.float32).reshape((4,) + (1,) * (x.ndim - 1))
            d = (np.round((x - res[k].numpy()) / s)
                 - np.round((x - ref[f"res_{k}{step}"]) / s))
            _residuals_agree(res[k].numpy(), ref[f"res_{k}{step}"], d, s)
