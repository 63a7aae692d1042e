"""The port's join mask entry point against the reference's mask kernel.

``repro_torch.core.join.compat_mask`` (device default on the CPU: the
plain version) and ``kernels.compat_join.ops.compat_mask`` are held to
the Pallas mask kernel in interpret mode
(``repro.kernels.compat_join.ops.compat_mask(..., interpret=True)``):
unbatched (B3) and under ``jax.vmap`` with shared B tables and per-slot
windows (B4, the custom-vmap rule).  Bool masks must be equal element
for element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.compat_join import ops as ref_ops

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.core import join as TJ
from repro_torch.kernels.compat_join import ops

LEVEL = (np.array([[False, False], [True, False]]),
         np.array([[-1]], np.int8))
L0 = (np.eye(3, dtype=bool) * np.array([1, 0, 0], bool),
      np.array([[0, -1], [1, 0]], np.int8))


def _tables(rng, ca, cb, spec, n_slots=None):
    rel, trel = spec
    lead = () if n_slots is None else (n_slots,)
    ba = rng.integers(0, 6, lead + (ca, rel.shape[0]), dtype=np.int32)
    ea = np.sort(rng.integers(0, 40, lead + (ca, trel.shape[0]),
                              dtype=np.int32), -1)
    va = rng.random(lead + (ca,)) < 0.7
    bb = rng.integers(0, 6, (cb, rel.shape[1]), dtype=np.int32)
    eb = np.sort(rng.integers(10, 50, (cb, trel.shape[1]), dtype=np.int32),
                 -1)
    vb = rng.random(lead + (cb,)) < 0.7
    return ba, ea, va, bb, eb, vb


CASES = [("level", LEVEL, 40, 150), ("l0", L0, 48, 64)]


@pytest.mark.parametrize("window", [None, 20], ids=["no_window", "window"])
@pytest.mark.parametrize("name,spec,ca,cb", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("entry", ["core_join", "ops"])
def test_mask_equals_interpreted_kernel(entry, name, spec, ca, cb, window):
    rng = np.random.default_rng(ca + cb)
    t = _tables(rng, ca, cb, spec)
    want = np.asarray(ref_ops.compat_mask(
        *(jnp.asarray(x) for x in t), *spec, window, interpret=True))
    port = [torch.as_tensor(x) for x in t]
    for k in (0, 1, 2, 5):                # A tables and valid_b: S = 1
        port[k] = port[k][None]
    if entry == "core_join":
        got = TJ.compat_mask(*port, *spec, window=window)
    else:
        got = ops.compat_mask(*port, *spec, window)
    assert got.dtype == torch.bool and got.shape == (1, ca, cb)
    assert want.dtype == np.bool_
    assert np.array_equal(want, got[0].numpy()), name
    assert want.any() and not want.all()


@pytest.mark.parametrize("window", [None, "per_slot"])
def test_stacked_mask_equals_vmapped_kernel(window):
    """Slot-stacked A and valid_b, shared B tables, per-slot windows."""
    n_slots = 4
    rng = np.random.default_rng(5)
    rel, trel = LEVEL
    ba, ea, va, bb, eb, vb = _tables(rng, 32, 96, LEVEL, n_slots=n_slots)
    wins = np.array([8, 15, 25, 40], np.int32)

    def one(ba, ea, va, vb, w):
        return ref_ops.compat_mask(
            ba, ea, va, jnp.asarray(bb), jnp.asarray(eb), vb, rel, trel,
            None if window is None else w, interpret=True)

    want = np.asarray(jax.vmap(one)(
        *(jnp.asarray(x) for x in (ba, ea, va, vb, wins))))
    got = TJ.compat_mask(
        torch.as_tensor(ba), torch.as_tensor(ea), torch.as_tensor(va),
        torch.as_tensor(bb), torch.as_tensor(eb), torch.as_tensor(vb),
        rel, trel, window=None if window is None else torch.as_tensor(wins))
    assert got.shape == (n_slots, 32, 96) and got.dtype == torch.bool
    assert np.array_equal(want, got.numpy())
    assert want.any()


def test_cuda_backend_refuses_cpu_tensors():
    rng = np.random.default_rng(0)
    t = [torch.as_tensor(x) for x in _tables(rng, 8, 8, LEVEL, n_slots=1)]
    with pytest.raises(ValueError, match="CUDA"):
        TJ.compat_mask(*t, *LEVEL, backend=TJ.JoinBackend.CUDA)
    with pytest.raises(ValueError, match="unknown"):
        TJ.compat_mask(*t, *LEVEL, backend="pallas")
