"""The per-device dry run of the production meshes (``launch.dryrun``):
rank 0's program of ``pod16x16`` under the "fake" process-group backend
at world 256, on meta tensors, in one process.

A subprocess (the fake group is process-wide) runs ``python -m
repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k``, which
must write a ``pod16x16`` record with collective records and at most
1.0e15 FLOPs a device (the query heads in padded groups of 3 over the
16-way model axis; every head on every rank made 2.54e15), and traces a
cut qwen3-14b training cell (2 layers at full width, global batch 16 of
256 tokens) on ``h100x1`` and on ``pod16x16``: the per-device reckoned
peak of the mesh's rank must be at most the one card's.  Another
records qwen3-14b's ``decode_32k`` on ``pod16x16``: the weight-stationary
step moves at most 1e9 bytes a device (a step that gathered the layers'
weights moved 26.5e9) and gathers nothing larger than the whole logits,
in at most 1e11 FLOPs.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_DECODE = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.cells import build_cell

    rec = DR.run_cell("qwen3-14b", "decode_32k", False, out_dir=sys.argv[1],
                      force=True)
    assert rec["ok"], rec.get("traceback")
    cell = build_cell("qwen3-14b", "decode_32k", DR.fake_mesh(False))
    cfg = cell.fn.keywords["cfg"]
    rec["logits_bytes"] = cell.args[1].shape[0] * cfg.vocab * 2
    print("DECODE " + json.dumps(rec))
""")

_CUT = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.cells import cell_for

    arch = get_arch("qwen3-14b")
    arch = dataclasses.replace(arch, config=dataclasses.replace(
        arch.config, n_layers=2))
    shape = dataclasses.replace(arch.shape("train_4k"), global_batch=16,
                                seq_len=256, microbatches=1)
    out = {}
    for mp in (None, False):
        rec = DR.run_cell(arch.arch_id, shape.name, mp, out_dir=sys.argv[1],
                          force=True, cell_fn=lambda mesh: cell_for(
                              arch, shape, mesh=mesh))
        assert rec["ok"], rec.get("traceback")
        out[rec["mesh"]] = rec
    print("CUT " + json.dumps({k: {
        "peak": v["memory"]["peak_bytes_per_device"],
        "n_ops": v["collectives"]["n_ops"], "n_chips": v["n_chips"],
        "flops": v["cost"]["flops"]} for k, v in out.items()}))
""")


def test_pod16x16_record_of_qwen3_train(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-14b", "--shape", "train_4k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    with open(tmp_path / "pod16x16" / "qwen3-14b__train_4k.json") as f:
        rec = json.load(f)
    assert rec["ok"] and rec["mesh"] == "pod16x16" and rec["n_chips"] == 256
    coll = rec["collectives"]
    assert coll["n_ops"] == len(coll["records"]) > 0
    kinds = {r[0] for r in coll["records"]}
    # FSDP's gathers and their gradients' reduce-scatters, TP's sums
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds
    assert {r[2] for r in coll["records"]} <= {16, 256}
    assert coll["total"] > 0 and rec["roofline"]["n_chips"] == 256
    assert rec["memory"]["fits"]
    assert rec["roofline"]["hlo_flops_per_device"] <= 1.0e15


def test_pod16x16_record_of_qwen3_decode_moves_activations(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _DECODE, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("DECODE "))
    rec = json.loads(line[7:])
    assert rec["mesh"] == "pod16x16" and rec["n_chips"] == 256
    assert (tmp_path / "pod16x16" / "qwen3-14b__decode_32k.json").exists()
    roof, coll = rec["roofline"], rec["collectives"]
    assert 0 < roof["wire_bytes_per_device"] <= 1e9
    assert 0 < roof["hlo_flops_per_device"] <= 1e11
    assert {r[0] for r in coll["records"]} <= {"all-gather", "all-reduce"}
    assert max(r[1] for r in coll["records"] if r[0] == "all-gather") \
        <= rec["logits_bytes"]


def test_cut_cell_per_device_peak_is_under_one_cards(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _CUT, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("CUT "))
    got = json.loads(line[4:])
    one, pod = got["h100x1"], got["pod16x16"]
    assert one["n_ops"] == 0 and pod["n_ops"] > 0
    assert (one["n_chips"], pod["n_chips"]) == (1, 256)
    assert 0 < pod["peak"] <= one["peak"]
    assert 0 < pod["flops"] < one["flops"]
    assert (tmp_path / "pod16x16" / "qwen3-14b__train_4k.json").exists()
