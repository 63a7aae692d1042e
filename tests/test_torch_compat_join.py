"""The port's plain compat join against the reference's.

Inputs are made with numpy from a seed.  Against the reference REF join
(``repro.core.join.join_pairs``) the port's plain version must agree
element for element, overflow included.  Against the Pallas kernel in
interpret mode (``repro.kernels.compat_join.ops.compat_join_pairs(...,
interpret=True)``), which emits pairs in tile order, the pair SETS and
the exact ``n_dropped`` must agree.  The stacked [S] form is held
against ``jax.vmap`` of the reference op with a shared B operand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import join as RJ
from repro.kernels.compat_join import ops as ref_ops

from _torch_util import leaves
from repro_torch.core import join as TJ
from repro_torch.kernels.compat_join import ops

# (rel, trel) specs of the engine's joins: a level join of a chain
# (A = (a, b), B = one edge, b == src, A's last edge before B's) and the
# L0 join of the two-chain query (shared first vertex, no timing order).
LEVEL = (np.array([[False, False], [True, False]]),
         np.array([[-1]], np.int8))
L0 = (np.eye(3, dtype=bool) * np.array([1, 0, 0], bool),
      np.array([[0, -1], [1, 0]], np.int8))


def _tables(rng, ca, cb, spec, n_vertices=6, fill=0.7, n_slots=None):
    rel, trel = spec
    nva, nvb = rel.shape
    nea, neb = trel.shape
    lead = () if n_slots is None else (n_slots,)
    ba = rng.integers(0, n_vertices, lead + (ca, nva), dtype=np.int32)
    ea = np.sort(rng.integers(0, 40, lead + (ca, nea), dtype=np.int32), -1)
    va = rng.random(lead + (ca,)) < fill
    bb = rng.integers(0, n_vertices, (cb, nvb), dtype=np.int32)
    eb = np.sort(rng.integers(10, 50, (cb, neb), dtype=np.int32), -1)
    vb = rng.random(lead + (cb,)) < fill
    return ba, ea, va, bb, eb, vb


def _port(tables, n_slots=None):
    """Port operands: A gets a slot axis (of 1 for a single join)."""
    ba, ea, va, bb, eb, vb = (torch.as_tensor(x) for x in tables)
    if n_slots is None:
        ba, ea, va, vb = ba[None], ea[None], va[None], vb[None]
    return ba, ea, va, bb, eb, vb


def _pairs(a, b, v):
    return sorted(zip(np.asarray(a)[np.asarray(v)].tolist(),
                      np.asarray(b)[np.asarray(v)].tolist()))


CASES = [
    ("level", LEVEL, 40, 150, 12, 256),
    ("level_window", LEVEL, 40, 150, 12, 256),
    ("l0", L0, 48, 64, None, 512),
    ("l0_window", L0, 48, 64, 20, 512),
    ("level_overflow", LEVEL, 40, 150, 30, 7),
    ("l0_overflow", L0, 48, 64, None, 5),
]


@pytest.mark.parametrize("name,spec,ca,cb,window,max_new", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_join_equals_reference_ref_elementwise(
        name, spec, ca, cb, window, max_new):
    rng = np.random.default_rng(7)
    t = _tables(rng, ca, cb, spec)
    want = RJ.join_pairs(*(jnp.asarray(x) for x in t), *spec, max_new,
                         window=window, backend=RJ.JoinBackend.REF)
    got = TJ.join_pairs(*_port(t), *spec, max_new, window=window,
                        backend=TJ.JoinBackend.REF)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g[0].numpy()), name
    assert int(want[2].sum()) > 0, "the case must have matches"
    if "overflow" in name:
        assert int(got[3][0]) > 0


@pytest.mark.parametrize("name,spec,ca,cb,window,max_new", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_join_equals_interpreted_kernel(
        name, spec, ca, cb, window, max_new):
    rng = np.random.default_rng(11)
    t = _tables(rng, ca, cb, spec)
    ka, kb, kv, kd = ref_ops.compat_join_pairs(
        *(jnp.asarray(x) for x in t), *spec, max_new, window=window,
        interpret=True)
    pa, pb, pv, pd = ops.compat_join_pairs(*_port(t), *spec, max_new,
                                           window)
    assert int(kd) == int(pd[0])
    if "overflow" in name:
        # both keep max_new pairs of the same join; the kernel's subset
        # is its tile order, the port's the row-major prefix
        full = ops.compat_join_pairs(*_port(t), *spec, ca * cb, window)
        every = set(_pairs(full[0][0], full[1][0], full[2][0]))
        kept = _pairs(ka, kb, kv)
        assert len(kept) == max_new and set(kept) <= every
        assert len(every) == max_new + int(pd[0])
    else:
        assert _pairs(ka, kb, kv) == _pairs(pa[0], pb[0], pv[0])


@pytest.mark.parametrize("window", [None, "per_slot"])
@pytest.mark.parametrize("backend", ["ref", "interpret"])
def test_stacked_join_equals_vmapped_reference(backend, window):
    """Slot-stacked A and valid_b, shared B tables, per-slot windows."""
    n_slots, max_new = 4, 64
    rng = np.random.default_rng(3)
    rel, trel = LEVEL
    ba, ea, va, bb, eb, vb = _tables(rng, 32, 96, LEVEL, n_slots=n_slots)
    wins = np.array([8, 15, 25, 40], np.int32)

    def one(ba, ea, va, vb, w):
        w = None if window is None else w
        if backend == "ref":
            return RJ.join_pairs(ba, ea, va, jnp.asarray(bb),
                                 jnp.asarray(eb), vb, rel, trel, max_new,
                                 window=w)
        return ref_ops.compat_join_pairs(
            ba, ea, va, jnp.asarray(bb), jnp.asarray(eb), vb, rel, trel,
            max_new, window=w, interpret=True)

    want = jax.vmap(one)(*(jnp.asarray(x) for x in (ba, ea, va, vb, wins)))
    got = ops.compat_join_pairs(
        torch.as_tensor(ba), torch.as_tensor(ea), torch.as_tensor(va),
        torch.as_tensor(bb), torch.as_tensor(eb), torch.as_tensor(vb),
        rel, trel, max_new,
        None if window is None else torch.as_tensor(wins))
    assert int(np.asarray(want[2]).sum()) > 0
    if backend == "ref":
        for w, g in zip(leaves(want), leaves(got)):
            assert np.array_equal(w, g)
    else:
        assert np.array_equal(np.asarray(want[3]), got[3].numpy())
        for s in range(n_slots):
            assert _pairs(want[0][s], want[1][s], want[2][s]) == \
                _pairs(got[0][s], got[1][s], got[2][s])


@pytest.mark.parametrize("size", [1, 5, 16, 40])
def test_first_true_and_alloc_slots_match_reference(size):
    rng = np.random.default_rng(size)
    mask = rng.random((3, 32)) < 0.4
    want = np.stack([np.asarray(jnp.nonzero(jnp.asarray(m), size=size,
                                            fill_value=-1)[0])
                     for m in mask])
    assert np.array_equal(want, TJ.first_true(torch.as_tensor(mask),
                                              size).numpy())
    valid = rng.random((3, 24)) < 0.6
    need = rng.random((3, size)) < 0.5
    for s in range(3):
        w = RJ.alloc_slots(jnp.asarray(valid[s]), jnp.asarray(need[s]), size)
        g = TJ.alloc_slots(torch.as_tensor(valid[s:s + 1]),
                           torch.as_tensor(need[s:s + 1]), size)
        for x, y in zip(w, g):
            assert np.array_equal(np.asarray(x), y[0].numpy())


def test_cuda_backend_refuses_cpu_tensors():
    rng = np.random.default_rng(0)
    t = _port(_tables(rng, 8, 8, LEVEL))
    with pytest.raises(ValueError, match="CUDA"):
        TJ.join_pairs(*t, *LEVEL, 4, backend=TJ.JoinBackend.CUDA)
    with pytest.raises(ValueError, match="unknown"):
        TJ.join_pairs(*t, *LEVEL, 4, backend="pallas")
