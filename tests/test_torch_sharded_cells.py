"""The port's model cells on a process-group mesh, held against the
reference's sharded cells.

One subprocess (``tests/_torch_cells_ref.py``, 4 virtual CPU devices, an
``Auto``-typed 2 × 2 ``("data", "model")`` mesh and a 2 × 1 × 2
``("pod", "data", "model")`` one) records the reference's cells of
``tests/_torch_cells_ranks.CASES`` at cut configurations: Wide&Deep's
train, serve and retrieval cells, GIN's full-graph cell, GIN's, GAT's,
PNA's and NequIP's ``ogb_products`` cells cut to 301 nodes (the node-dim
tensors sharded as well as the edges; GIN's, GAT's and PNA's also with
their bf16 activations in float32 on both sides), qwen3-14b's
smoke configuration (vocab 512, float32) through train (2
microbatches), prefill and decode (a batch under the data axes too, and
on the 3-axis mesh), with 3 heads on the 2-way model axis (padded
groups of 2 and 1) and 1 (a model rank without heads), and with tied
embeddings, arctic-480b's (MoE in 2 groups; its decode's experts over
model) and grok-1-314b's (each expert's d_ff sharded over model, in
training and decode).  It writes every global argument, each
device's block of it and every global output.  Then 4 gloo ranks
(``tests/_torch_cells_ranks.py``, spawned once) build the port's cells
on the same meshes: each rank's argument blocks must equal the
reference's device blocks at its mesh coordinates bit for bit (for three
cases, the 3-axis mesh's among them, DTensor's block under the spec's
placements as well), and the
outputs, gathered, must equal the reference's within these tolerances
(float32 sums reorder across the ranks):

* train cells: loss and grad_norm rtol 1e-5 (Wide&Deep, GIN) or 1e-4
  (the LM family, the LM training checks' bound), 2e-2 for the GNNs'
  bf16 ``ogb_products`` cells (node-dim tensors sharded; bf16 sums
  reorder, and the reference's own one-device step differs from its
  sharded one as much: PNA's first moments by more than their largest
  value, so no state bound holds there; the cases' float32 variants
  hold the states); every optimiser state
  leaf within 1e-4 of its largest value (PNA's 1e-3: its std aggregator
  magnifies float32 reordering; an int8 moment within 1); every
  parameter within ``lr·|Δstep| + 16 ulps`` of its operands (``Δstep``
  the two sides' Adam steps, from their states, plus one quantum's step
  where the first moment is int8, whose state hides a difference under
  a quantum);
* logits and float32 caches within 1e-4 of the largest value; bfloat16
  caches within one bfloat16 rounding (2^-8 relative); retrieval scores
  rtol 1e-5 and the same candidates (random scores have no ties);
* a decode step is weight-stationary: its collectives, recorded on the
  ranks, are all-reduces and all-gathers, none larger than the whole
  logits, and move under a tenth of the bytes of the layers' weights
  (what a step that gathered them would take in).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_cells_ranks as CR

ROOT = Path(__file__).resolve().parents[1]
CASES = list(CR.CASES)
LRS = {"lm": 1e-4, "gnn": 1e-3, "nequip": 1e-3, "recsys": 1e-3}


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_cells")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         str(ROOT / "tests")])
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_cells_ref.py"),
         str(out)] + CASES, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    CR.run({"dir": str(out), "ref": str(out / "ref_args.npz"),
            "cases": CASES})
    ref_args = np.load(out / "ref_args.npz")
    ref_out = np.load(out / "ref_out.npz")
    port = np.load(out / "port.npz")
    yield {"args": ref_args, "ref": ref_out, "port": port}


def _outs(data, case: str) -> list:
    out, i = [], 0
    while f"{case}|out{i}" in data:
        out.append(data[f"{case}|out{i}"])
        i += 1
    return out


def _structure(case: str):
    """The port's one-process cell of ``case`` on the meta device: its
    parameter tree and optimiser state tree (the outputs' layout)."""
    from repro_torch.launch.cells import cell_for

    arch, shape = CR.port_cell_spec(CR.CASES[case])
    cell = cell_for(arch, shape)
    return arch, shape, cell.args[0].params(), cell.args[1]


def _adam_steps(states, count: int):
    """Each parameter's Adam step in float64 from its state dict, and
    the step of one quantum of an int8 first moment (0 for a float32
    one): the int8 state hides any difference of the moments under a
    quantum."""
    from repro_torch.optim import AdamWConfig

    cfg = AdamWConfig()
    c1, c2 = 1 - cfg.b1 ** count, 1 - cfg.b2 ** count
    out = []
    for st in states:
        quantum = 0.0
        if "m_q" in st:
            sc = np.asarray(st["m_scale"], np.float64)
            quantum = sc.reshape(sc.shape + (1,) * (st["m_q"].ndim
                                                    - sc.ndim))
            m = st["m_q"].astype(np.float64) * quantum
        else:
            m = np.asarray(st["m"], np.float64)
        if "vr" in st:
            vr = np.asarray(st["vr"], np.float64)
            vc = np.asarray(st["vc"], np.float64)
            den = np.maximum(vr.mean(-1, keepdims=True), 1e-30)
            v = vr[..., :, None] * vc[..., None, :] / den[..., None]
        else:
            v = np.asarray(st["v"], np.float64)
        den = np.sqrt(v / c2) + cfg.eps
        out.append(((m / c1) / den, (quantum / c1) / den))
    return out


def _check_train(case, ref, port):
    from repro_torch.optim.tree import flatten, flatten_up_to, unflatten

    arch, _, params, opt = _structure(case)
    lr = LRS[arch.family]
    n_p = len(flatten(params))
    n_s = len(flatten(opt))
    assert len(ref) == len(port) == n_p + n_s + 2
    rl, rg = ref[-2:]
    tl, tg = port[-2:]
    bf16 = CR.CASES[case]["shape"] == "ogb_products" \
        and arch.family == "gnn" and not CR.CASES[case].get("float32")
    rtol = 2e-2 if bf16 else 1e-4 if arch.family == "lm" else 1e-5
    np.testing.assert_allclose(tl, rl, rtol=rtol, err_msg=f"{case} loss")
    np.testing.assert_allclose(tg, rg, rtol=rtol,
                               err_msg=f"{case} grad_norm")

    def states(flat):
        tree = unflatten(opt, flat[n_p:n_p + n_s])
        return flatten_up_to(params, tree["leaves"])

    r_st, t_st = states(ref), states(port)
    # PNA's std aggregator, sqrt(var + 1e-6), magnifies a reordered
    # float32 variance near 0 up to 500 times: the reference's own
    # sharded and one-device steps differ by 9e-5 of a moment's largest
    stol = 1e-3 if CR.CASES[case]["arch"] == "pna" else 1e-4
    for i, (a, b) in enumerate(zip(t_st, r_st)):
        if bf16:        # the float32 variant of the case holds them
            break
        for k in b:
            if k == "m_q":
                assert np.abs(a[k].astype(int) - b[k]).max() <= 1, (case, i)
                continue
            scale = float(np.abs(b[k]).max())
            np.testing.assert_allclose(a[k], b[k], rtol=0,
                                       atol=stol * scale + 1e-30,
                                       err_msg=f"{case} state {i} {k}")
    for i, (a, b, (sa, _), (sb, qb)) in enumerate(zip(
            port[:n_p], ref[:n_p], _adam_steps(t_st, 1),
            _adam_steps(r_st, 1))):
        tol = lr * (np.abs(sa - sb) + qb) \
            + 16 * 2.0 ** -24 * (np.abs(b) + lr * (np.abs(sb) + 1))
        assert (np.abs(a.astype(np.float64) - b) <= tol).all(), \
            f"{case} parameter leaf {i}: {np.abs(a - b).max()}"


@pytest.mark.parametrize("case", CASES)
def test_rank_blocks_and_outputs_equal_the_reference(recorded, case):
    args, ref, port = recorded["args"], recorded["ref"], recorded["port"]
    n_args = sum(1 for k in args.files
                 if k.startswith(f"{case}|arg") and "|dev" not in k)
    # every rank checked every one of its argument blocks against the
    # reference's device block (the ranks assert it; here the count)
    assert int(port[f"{case}|blocks"]) == n_args > 0
    if case in CR.DTENSOR_CASES:      # DTensor's blocks checked too
        assert int(port[f"{case}|dtensor"]) > 0
    r, t = _outs(ref, case), _outs(port, case)
    assert [x.shape for x in r] == [x.shape for x in t]
    kind = CR.CASES[case]["shape"]
    if kind in ("train_batch", "train_4k", "full_graph_sm", "ogb_products"):
        _check_train(case, r, t)
    elif kind == "retrieval_cand":
        np.testing.assert_allclose(t[0], r[0], rtol=1e-5)
        np.testing.assert_array_equal(t[1], r[1])
    elif kind == "decode_32k":
        logits, caches, length = (t[0], r[0]), list(zip(t[1:3], r[1:3])), \
            (t[3], r[3])
        np.testing.assert_allclose(*logits, rtol=0,
                                   atol=1e-4 * np.abs(r[0]).max())
        for a, b in caches:
            assert (np.abs(a - b) <= 2.0 ** -8 * np.abs(b) + 1e-6).all()
        np.testing.assert_array_equal(*length)
        # weight-stationary: the step's collectives carry activations
        # only, the largest the whole logits
        records = port[f"{case}|records"]
        assert len(records) > 0
        gathers = records[records[:, 0] == CR.KINDS.index("all-gather")]
        assert gathers[:, 1].max() <= r[0].nbytes
        assert set(records[:, 0]) <= {CR.KINDS.index("all-reduce"),
                                      CR.KINDS.index("all-gather")}
        assert records[:, 1].sum() * 10 < port[f"{case}|weight_bytes"]
    else:                      # serve logits; prefill logits and caches
        for a, b in zip(t, r):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-4 * np.abs(b).max() + 1e-7)


def test_cases_cover_the_slice():
    """The families, the cell kinds, the MoE groups and the 3-axis mesh
    (tuple spec entries) are all among the cases."""
    archs = {c["arch"] for c in CR.CASES.values()}
    shapes = {c["shape"] for c in CR.CASES.values()}
    meshes = {c["mesh"][1] for c in CR.CASES.values()}
    assert {"wide-deep", "gin-tu", "gat-cora", "pna", "nequip",
            "qwen3-14b", "arctic-480b"} <= archs
    assert {"train_batch", "serve_p99", "retrieval_cand", "full_graph_sm",
            "ogb_products", "train_4k", "prefill_32k", "decode_32k"} <= shapes
    assert ("pod", "data", "model") in meshes
    cfgs = [c["config"] for c in CR.CASES.values()]
    # the sharded branches: heads that do not split over model, tied
    # embeddings, each expert's d_ff over model
    assert any(c.get("n_heads", 4) % 2 for c in cfgs)
    assert any(c.get("tie_embeddings") for c in cfgs)
    assert "grok-1-314b" in archs
    small = [c for c in CR.CASES.values() if c["shape"] == "decode_32k"
             and c["shape_kw"]["global_batch"] < 2]
    assert small          # the serving rule's positions over every axis
    decodes = [c for c in CR.CASES.values() if c["shape"] == "decode_32k"]
    # both MoE shardings and the 3-axis mesh decode too
    assert {"arctic-480b", "grok-1-314b"} <= {c["arch"] for c in decodes}
    assert ("pod", "data", "model") in {c["mesh"][1] for c in decodes}
    # a model rank past the padded heads (1 head on the 2-way axis)
    assert any(c.get("n_heads", 4) == 1 for c in cfgs)


@pytest.mark.parametrize("n_heads,tp", [(40, 16), (3, 2), (1, 2), (48, 16),
                                        (4, 2)])
def test_head_blocks_are_padded_groups(n_heads, tp):
    """Rank t of the model axis computes heads [t·c, min(H, (t+1)·c)),
    c = ⌈H/tp⌉: at most c heads a rank, every head once."""
    from repro_torch.models.attention import head_block

    c = -(-n_heads // tp)
    blocks = [head_block(n_heads, tp, t) for t in range(tp)]
    assert max(h1 - h0 for h0, h1 in blocks) == c
    assert [h for h0, h1 in blocks for h in range(h0, h1)] == \
        list(range(n_heads))
    if (n_heads, tp) == (40, 16):
        assert blocks[13] == (39, 40) and blocks[14] == blocks[15] == (40, 40)


def test_rank_module_imports_no_jax():
    """The rank processes run the port alone."""
    import ast

    tree = ast.parse(Path(CR.__file__).read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not names & {"jax", "repro"}, names
