"""The port's checkpoints against the JAX package's.

* The file format is the reference's: after the same N REF ticks the
  port's service checkpoint holds the same npz keys with bit-identical
  arrays (sharing on and off), and its manifest the same keys.
* A reference service checkpoint restores into the port (``backend=
  "ref"``) and, fed the rest of the stream, gives the reference's
  matches; a reference manifest naming a Pallas backend refuses to
  restore without an explicit ``backend=``.
* Round-trip, hash-while-write, torn and partial steps skipped, a torn
  manifest/npz pair, loud schema drift, pruning, ``service_delta``
  chains and the fallback to the last full base, the async writer's
  synchronous snapshot.
"""

import hashlib
import json
import os
import warnings
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as ref_save
from repro.core.join import JoinBackend as RefBackend
from repro.core.multi import SlotTickCache as RefSlotTickCache
from repro.runtime.service import ContinuousSearchService as RefService

from _torch_util import assert_same_tree, port_edges, port_query
from repro_torch.checkpoint import (
    AsyncCheckpointer,
    CheckpointError,
    apply_patch,
    checkpoint_steps,
    dict_diff,
    latest_step,
    load_manifest,
    load_resolved_manifest,
    prune_checkpoints,
    restore_checkpoint,
    save_checkpoint,
    validate_checkpoint,
)
from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.core.multi import SlotTickCache
from repro_torch.runtime.service import ContinuousSearchService
from test_engine_oracle import small_stream, tri_query
from test_service_restore import chain_query
from test_share import W, chain2, chain3, fork

CAP = dict(level_capacity=128, l0_capacity=128, max_new=64)
SERVE = dict(batch_size=16, min_batch=16, max_batch=16)


class _Pair(NamedTuple):
    a: torch.Tensor
    b: tuple


def _tree():
    return {"w": torch.arange(12, dtype=torch.int32).reshape(3, 4),
            "p": _Pair(torch.tensor([True, False]),
                       (torch.zeros((), dtype=torch.int32),
                        torch.ones(5, dtype=torch.int32))),
            "n": [np.arange(3.0)]}


def _leaves_equal(x, y):
    xs = [x] if not isinstance(x, (tuple, list, dict)) else (
        [v for k in sorted(x) for v in [x[k]]] if isinstance(x, dict)
        else list(x))
    ys = [y] if not isinstance(y, (tuple, list, dict)) else (
        [v for k in sorted(y) for v in [y[k]]] if isinstance(y, dict)
        else list(y))
    if len(xs) == 1 and xs[0] is x:
        a = x.numpy() if torch.is_tensor(x) else np.asarray(x)
        b = y.numpy() if torch.is_tensor(y) else np.asarray(y)
        return a.shape == b.shape and np.array_equal(a, b)
    return all(_leaves_equal(a, b) for a, b in zip(xs, ys))


# --------------------------------------------------------------------- #
# the file format: keys and arrays
# --------------------------------------------------------------------- #
def test_roundtrip_keys_types_and_zero_dim(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 7, tree)
    assert latest_step(str(tmp_path)) == 7
    with np.load(tmp_path / "step_7.npz") as z:
        assert sorted(z.files) == sorted(
            ["n::0", "p::.a", "p::.b::0", "p::.b::1", "w"])
    got = restore_checkpoint(str(tmp_path), 7, tree)
    assert isinstance(got["p"], _Pair) and isinstance(got["n"], list)
    assert got["p"].b[0].shape == () and got["p"].a.dtype == torch.bool
    assert isinstance(got["n"][0], np.ndarray)
    assert _leaves_equal(tree, got)


def test_reference_writes_and_reads_the_same_files(tmp_path):
    """A tree saved by either package restores in the other, key for
    key."""
    import jax.numpy as jnp

    from repro.checkpoint import restore_checkpoint as ref_restore

    ref_tree = {"a": jnp.arange(6, dtype=jnp.int32),
                "b": {"c": jnp.array(True), "d": [jnp.ones(2, jnp.int32)]}}
    ref_save(str(tmp_path / "r"), 3, ref_tree)
    like = {"a": torch.zeros(6, dtype=torch.int32),
            "b": {"c": torch.tensor(False),
                  "d": [torch.zeros(2, dtype=torch.int32)]}}
    got = restore_checkpoint(str(tmp_path / "r"), 3, like)
    assert got["a"].tolist() == list(range(6)) and bool(got["b"]["c"])
    save_checkpoint(str(tmp_path / "p"), 3, got)
    back = ref_restore(str(tmp_path / "p"), 3, ref_tree)
    assert np.array_equal(np.asarray(back["a"]), np.arange(6))
    assert np.asarray(back["b"]["d"][0]).tolist() == [1, 1]


def _serve_pair(tmp_path, share, n_ticks, queries):
    stream = small_stream(n_ticks * 16, n_vertices=8, seed=61)
    ref = RefService(slots_per_group=2, tick_cache=RefSlotTickCache(),
                     enable_sharing=share, ckpt_dir=str(tmp_path / "ref"),
                     **CAP)
    port = ContinuousSearchService(
        slots_per_group=2, tick_cache=SlotTickCache(), enable_sharing=share,
        ckpt_dir=str(tmp_path / "port"), device="cpu", **CAP)
    for q in queries:
        assert ref.register(q, W) == port.register(port_query(q), W)
    ref.serve_stream(stream, ckpt_every=n_ticks, **SERVE)
    port.serve_stream(port_edges(stream), ckpt_every=n_ticks, **SERVE)
    return ref, port


@pytest.mark.parametrize("share", [False, True])
def test_service_npz_equals_reference(tmp_path, share):
    """After the same N REF ticks the port's checkpoint holds the
    reference's keys with bit-identical arrays; the manifests carry the
    same keys, registry, groups, forest and counters."""
    n = 4
    queries = [chain3(), chain2(), fork(), chain2()]
    _serve_pair(tmp_path, share, n, queries)
    with np.load(tmp_path / "ref" / f"step_{n}.npz") as r, \
            np.load(tmp_path / "port" / f"step_{n}.npz") as p:
        assert sorted(p.files) == sorted(r.files)
        assert any(k.startswith("prefix") for k in r.files) == share
        for k in r.files:
            assert p[k].shape == r[k].shape, k
            assert (p[k].dtype == np.bool_) == (r[k].dtype == np.bool_), k
            assert np.array_equal(p[k].astype(np.int64),
                                  r[k].astype(np.int64)), k
    rm = load_manifest(str(tmp_path / "ref"), n)
    pm = load_manifest(str(tmp_path / "port"), n)
    assert sorted(pm) == sorted(rm)
    rs, ps = rm["service"], pm["service"]
    assert sorted(ps) == sorted(rs) and sorted(ps["config"]) == \
        sorted(rs["config"])
    for key in ("queries", "groups", "forest", "counters", "extra",
                "ingest", "obs"):
        assert ps[key] == rs[key], key
    assert ps["config"]["backend"] == "ref"


def test_reference_checkpoint_restores_into_port(tmp_path):
    """Serve half the stream on the reference, restore its checkpoint
    into the port, feed both the rest: the port ends with the
    reference's matches and states, and its reports equal the
    reference's."""
    stream = small_stream(160, n_vertices=8, seed=62)
    queries = [chain3(), chain2(), fork()]
    ref = RefService(slots_per_group=2, tick_cache=RefSlotTickCache(),
                     enable_sharing=True, ckpt_dir=str(tmp_path), **CAP)
    qids = [ref.register(q, W) for q in queries]
    ref.serve_stream(stream[:80], ckpt_every=5, **SERVE)
    port = ContinuousSearchService.restore(str(tmp_path), device="cpu",
                                           tick_cache=SlotTickCache())
    assert port.backend == "ref" and port.registry.qids() == qids
    assert port.n_edges_ingested == 80 and port.n_ticks == 5

    got, want = {}, {}

    def collect(into):
        def on_match(qid, b, t):
            into.setdefault(qid, []).extend(
                tuple(map(int, x)) + tuple(map(int, y))
                for x, y in zip(b, t))
        return on_match

    ref.serve_stream(stream[80:], on_match=collect(want), **SERVE)
    port.serve_stream(port_edges(stream[80:]), on_match=collect(got),
                      **SERVE)
    assert got == want and want
    for qid in qids:
        assert port.matches(qid) == ref.matches(qid)
        assert_same_tree(ref.state(qid), port.state(qid), f"qid {qid}")


def test_pallas_backend_manifest_needs_an_override(tmp_path):
    stream = small_stream(32, n_vertices=8, seed=63)
    ref = RefService(slots_per_group=2, tick_cache=RefSlotTickCache(),
                     backend=RefBackend.PALLAS_INTERPRET,
                     ckpt_dir=str(tmp_path), **CAP)
    qid = ref.register(chain_query(), 20)
    ref.serve_stream(stream, ckpt_every=2, **SERVE)
    with pytest.raises(ValueError, match="pallas_interpret"):
        ContinuousSearchService.restore(str(tmp_path), device="cpu")
    port = ContinuousSearchService.restore(str(tmp_path), device="cpu",
                                           backend="ref")
    assert port.backend == "ref"
    assert port.matches(qid) == ref.matches(qid)


# --------------------------------------------------------------------- #
# crash consistency
# --------------------------------------------------------------------- #
def test_save_hashes_while_writing_no_reread(tmp_path, monkeypatch):
    def _boom(path):
        raise AssertionError(f"save re-read {path} to hash it")

    monkeypatch.setattr(ckpt_mod, "_sha256", _boom)
    tree = {"w": torch.arange(4096, dtype=torch.int32).reshape(64, 64)}
    save_checkpoint(str(tmp_path), 9, tree, extra={"tag": "hw"})
    monkeypatch.undo()
    want = load_manifest(str(tmp_path), 9)["npz_sha256"]
    got = hashlib.sha256((tmp_path / "step_9.npz").read_bytes()).hexdigest()
    assert want == got
    validate_checkpoint(str(tmp_path), 9)
    assert torch.equal(restore_checkpoint(str(tmp_path), 9, tree)["w"],
                       tree["w"])


@pytest.mark.parametrize("damage", ["truncate_npz", "bad_manifest",
                                    "no_manifest", "old_npz"])
def test_torn_and_partial_steps_are_skipped(tmp_path, damage):
    tree = {"w": torch.arange(6, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 3, tree)
    old_npz = (tmp_path / "step_3.npz").read_bytes()
    save_checkpoint(str(tmp_path), 7, {"w": tree["w"] + 1},
                    extra={"gen": 2})
    npz, man = tmp_path / "step_7.npz", tmp_path / "step_7.json"
    if damage == "truncate_npz":
        npz.write_bytes(npz.read_bytes()[:40])
    elif damage == "bad_manifest":
        man.write_text("{not json")
    elif damage == "no_manifest":
        os.remove(man)
    else:                        # crash mid-overwrite: new manifest, old npz
        npz.write_bytes(old_npz)
    assert checkpoint_steps(str(tmp_path)) == [3, 7]
    assert latest_step(str(tmp_path)) == 3
    with pytest.raises(CheckpointError):
        validate_checkpoint(str(tmp_path), 7)
    got = restore_checkpoint(str(tmp_path), 3, tree)
    assert got["w"].tolist() == list(range(6))


def test_missing_arrays_are_loud_schema_drift(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="missing"):
        restore_checkpoint(str(tmp_path), 1,
                           {"a": torch.ones(3), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), 1, {"a": torch.ones(4)})


def test_sharded_checkpoints_are_the_mesh_slice(tmp_path):
    with pytest.raises(NotImplementedError, match="mesh"):
        save_checkpoint(str(tmp_path), 1, {"a": torch.ones(4)}, n_shards=2)
    (tmp_path / "step_2.json").write_text(json.dumps(
        {"step": 2, "shards": {"n": 2, "sha256": ["x", "y"]}}))
    with pytest.raises(NotImplementedError, match="mesh"):
        validate_checkpoint(str(tmp_path), 2)


def test_async_writer_snapshots_before_returning(tmp_path):
    """The host copy is taken inside ``save``: writing into the tensor
    right after (as the next tick does to slot tables) cannot tear the
    checkpoint."""
    ck = AsyncCheckpointer(str(tmp_path))
    t = torch.zeros(1 << 16, dtype=torch.int32)
    for s in (10, 20):
        ck.save(s, {"w": t}, keep_last=1)
        t += 5                                 # the next tick's in-place write
    ck.wait()
    assert checkpoint_steps(str(tmp_path)) == [20]
    got = restore_checkpoint(str(tmp_path), 20, {"w": t})["w"]
    assert int(got.max()) == int(got.min()) == 5
    assert ck.last_write_s > 0


# --------------------------------------------------------------------- #
# retention and incremental manifests
# --------------------------------------------------------------------- #
def test_retention_keeps_last_k_and_restores(tmp_path):
    stream = port_edges(small_stream(160, n_vertices=9, seed=64))
    svc = ContinuousSearchService(slots_per_group=2, ckpt_dir=str(tmp_path),
                                  keep_checkpoints=3, device="cpu",
                                  tick_cache=SlotTickCache(), **CAP)
    qid = svc.register(port_query(chain_query()), 20)
    svc.serve_stream(stream, ckpt_every=1, **SERVE)
    steps = checkpoint_steps(str(tmp_path))
    assert len(steps) == 3 and steps[-1] == 10
    assert prune_checkpoints(str(tmp_path), 1) == [8, 9]
    svc2 = ContinuousSearchService.restore(str(tmp_path), device="cpu")
    assert svc2.n_edges_ingested == len(stream)
    assert svc2.matches(qid) == svc.matches(qid)
    bare = ContinuousSearchService(slots_per_group=2, device="cpu", **CAP)
    bare.register(port_query(chain_query()), 20)
    with pytest.raises(ValueError, match="ckpt_dir"):
        bare.serve_stream(stream, ckpt_every=5)


def test_dict_diff_apply_patch_roundtrip():
    old = {"a": 1, "b": {"c": [1, 2], "d": {"e": 3}}, "gone": 4}
    new = {"a": 1, "b": {"c": [1, 2, 3], "d": {"f": 5}}, "x": {"y": None}}
    patch = dict_diff(old, new)
    assert apply_patch(old, patch) == new
    assert "a" not in patch and patch["gone"] == {"__deleted__": True}
    assert dict_diff(new, new) == {}


def test_service_delta_chain_and_fallback_to_full_base(tmp_path):
    """With ``compact_every=3`` steps between full manifests carry
    ``service_delta`` patches; every step resolves to the manifest the
    service had at that step, and a torn link falls back (loudly) to
    the last full base."""
    stream = port_edges(small_stream(160, n_vertices=9, seed=65))
    svc = ContinuousSearchService(slots_per_group=2, ckpt_dir=str(tmp_path),
                                  compact_every=3, keep_checkpoints=20,
                                  device="cpu", tick_cache=SlotTickCache(),
                                  **CAP)
    resolved = {}
    qids = [svc.register(port_query(chain_query()), 20)]
    for i, q in enumerate([tri_query(), chain_query(), tri_query(),
                           chain_query(), tri_query()]):
        svc.serve_stream(stream[16 * i:16 * (i + 1)], ckpt_every=1,
                         final_checkpoint=False, **SERVE)
        svc.ckpt.wait()
        resolved[svc.n_ticks] = svc._manifest()
        if i % 2:
            svc.unregister(qids.pop(0))
        qids.append(svc.register(port_query(q), 25))
    steps = checkpoint_steps(str(tmp_path))
    assert steps == [1, 2, 3, 4, 5]
    kinds = ["service" if "service" in load_manifest(str(tmp_path), s)
             else "delta" for s in steps]
    assert kinds == ["service", "delta", "delta", "service", "delta"]
    for s in steps:
        assert load_resolved_manifest(str(tmp_path), s, "service") == \
            json.loads(json.dumps(resolved[s]))
    restored = ContinuousSearchService.restore(str(tmp_path), device="cpu")
    assert restored.n_ticks == 5

    # tear the link step 2 -> steps 3 falls back to the base at step 1
    os.remove(tmp_path / "step_2.json")
    n0 = ckpt_mod.N_DELTA_FALLBACKS
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with pytest.raises(CheckpointError):
            load_resolved_manifest(str(tmp_path), 3, "service")
    assert ckpt_mod.N_DELTA_FALLBACKS == n0 + 1 and w
    os.remove(tmp_path / "step_5.npz")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        back = ContinuousSearchService.restore(str(tmp_path), device="cpu")
    assert back.n_ticks == 4                 # the full base at step 4
    os.remove(tmp_path / "step_4.npz")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        back = ContinuousSearchService.restore(str(tmp_path), device="cpu")
    assert back.n_ticks == 1                 # 3 is torn: back to base 1
