"""``optim.compress.compressed_psum(group=)`` on 2 gloo ranks against the
reference's ``compressed_psum`` under ``shard_map`` on 2 virtual CPU
devices (a subprocess: the device count is set before JAX starts).

Rank r holds shard r's leaves, without the shard axis; the int8
payloads sum in an ``all_reduce``.  Two steps with error feedback, the
reference's residual carried in at the second.  Tolerances as the
one-controller test's (``test_torch_optim.py``): a rounding flipped by
one ulp of x / s moves one shard's int8 value by one, the mean by
s_max / 2 and that shard's residual by its own s.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

import _torch_cells_ranks as CR

ROOT = Path(__file__).resolve().parents[1]

_REF = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.core.compat import shard_map, shard_map_compat_kwargs
    from repro.optim.compress import compressed_psum

    data = np.load(sys.argv[1])
    mesh = jax.make_mesh((2,), ("data",))
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


def test_group_compressed_psum_equals_reference_under_shard_map(tmp_path):
    rng = np.random.default_rng(9)
    data = {}
    for step in range(2):
        # shard 1's values are larger: the shared scale is its scale
        scale = np.array([0.5, 3.0], np.float32)
        data[f"a{step}"] = (rng.standard_normal((2, 6, 5)).astype(np.float32)
                            * scale[:, None, None])
        data[f"b{step}"] = rng.standard_normal((2, 8)).astype(np.float32)
    np.savez(tmp_path / "in.npz", **data)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _REF, str(tmp_path / "in.npz"),
         str(tmp_path / "ref.npz")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    CR.run_psum({"dir": str(tmp_path), "data": str(tmp_path / "in.npz"),
                 "ref": str(tmp_path / "ref.npz")})
    ref = np.load(tmp_path / "ref.npz")
    got = np.load(tmp_path / "psum.npz")
    for step in range(2):
        for k in ("a", "b"):
            want, mean = ref[f"mean_{k}{step}"], got[f"mean_{k}{step}"]
            assert mean.shape == want.shape
            assert (mean == mean[:1]).all()     # every rank the same mean
            x = data[f"{k}{step}"] + (ref[f"res_{k}{step - 1}"] if step
                                      else 0)
            s = np.abs(x.reshape(2, -1)).max(1) / 127
            np.testing.assert_allclose(mean, want, rtol=1e-6,
                                       atol=s.max() / 2 * 1.01)
            assert (~np.isclose(mean, want, rtol=1e-5, atol=0)).mean() \
                <= 0.05
            s = s.astype(np.float32).reshape((2,) + (1,) * (x.ndim - 1))
            np.testing.assert_allclose(got[f"res_{k}{step}"],
                                       ref[f"res_{k}{step}"], rtol=1e-5,
                                       atol=s.max() * 1.01)
