"""Checkpointing: state-tree save/restore + async writer.

The port of ``repro.checkpoint.ckpt``, with the same file format, so a
checkpoint written by either package restores into the other:

* one ``step_<N>.npz`` per checkpoint (flattened key path -> array) plus
  a JSON manifest ``step_<N>.json`` carrying caller metadata (the
  ``extra`` dict — the ``ContinuousSearchService`` serialises its whole
  registry and slot layout there);
* key paths are the reference's: path parts joined by ``::``, a dict key
  as itself (dict keys visited in sorted order), a NamedTuple field as
  ``.name``, a tuple/list index as the integer — e.g.
  ``0::.engines::.levels::0::1::.src``.

Crash consistency: both files are written to a temp name and published
with ``os.replace``, manifest first and the ``.npz`` last — the ``.npz``
is the commit point.  The manifest records the npz's sha256, computed
while the file streams out (``_HashingWriter``), so a torn pair (a crash
between the two replaces of an overwritten step) is detected.  A torn
or partial checkpoint is skipped by ``latest_step`` and surfaces from
``restore_checkpoint``/``load_manifest`` as ``CheckpointError`` so
recovery paths fall back to the previous step.

Sharded checkpoints (``n_shards > 1``, the replica-sharded service of
``repro_torch.runtime.mesh``) split every non-replicated key along axis
0 into ``step_<N>.shard<r>of<R>.npz`` files, one per replica, with
replicated keys and scalars stored once in shard 0; shard 0 is published
last and is the commit point, and the manifest carries every shard's
sha256.  ``restore_checkpoint`` reassembles the shards on the host, so
the result does not depend on the mesh that wrote it.

The async writer copies every tensor to host memory synchronously before
``save`` returns (the service's slot tables are updated in place by the
next tick, so the snapshot must not alias them), then writes the file on
a background thread.

Placing a tree onto a mesh (``reshard``, ``restore_checkpoint(mesh=,
specs=)``; ``repro_torch.core.distributed``'s ``Mesh`` and
``PartitionSpec``) puts every leaf on the mesh's device and checks that
each sharded axis divides by its shard count.  The port keeps the
reference's global shapes on its one-controller mesh, so a capacity-
sharded state is saved as its concatenated global arrays under the
reference's keys, and a JAX sharded checkpoint (``save_checkpoint`` of
``jax.device_get`` of the state) restores into the port, and back.  A
generic restore cannot know the shard count that wrote an engine state
(its ``parent`` pointers are shard-local): an engine state goes back at
the same count, or through ``repro_torch.runtime.elastic.
scale_to_mesh``.

On a process-group mesh (``Mesh(group=...)``, one rank a device) and
for the replica service over a group, every rank writes its own blocks
in the sharded format above — ``step_<N>.shard<r>of<R>.npz``, replicated
keys and scalars in shard 0, which rank 0 owns — and rank 0 writes the
one manifest after the ranks have exchanged their shards' hashes; no
rank gathers the whole state.  The publish keeps the commit order:
manifest, a barrier, the shards after 0, a barrier, shard 0.  A restore
onto a process-group mesh reads, on each rank, only the files that hold
its rows, from either format: so a checkpoint written by n ranks
restores onto m ranks and onto the one-process mesh, and a
single-file checkpoint (the one-process mesh's, the reference's)
restores onto ranks.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
import warnings
import zipfile
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

SEP = "::"

# Torn-delta fallbacks observed by load_resolved_manifest in this
# process (a delta manifest chain that could not be replayed).
N_DELTA_FALLBACKS = 0


class CheckpointError(RuntimeError):
    """A checkpoint on disk is torn, partial, or unreadable."""


def _items(node):
    """Children of a tree node as (key part, child), or None for a leaf.
    ``None`` is an empty subtree."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", v) for f, v in zip(node._fields, node)]
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    if node is None:
        return []
    return None


def _walk(tree, path=()):
    """(key, leaf) pairs of ``tree`` in the reference's flatten order."""
    items = _items(tree)
    if items is None:
        yield SEP.join(path), tree
        return
    for part, child in items:
        yield from _walk(child, path + (part,))


def _to_host(x) -> np.ndarray:
    """A tensor leaf as an owned numpy copy (never a view of live
    state); a host array as is."""
    if torch.is_tensor(x):
        x = x.detach()
        return x.numpy().copy() if x.device.type == "cpu" \
            else x.cpu().numpy()
    return np.asarray(x)


def _flatten(tree) -> dict:
    return {key: _to_host(leaf) for key, leaf in _walk(tree)}


def _unflatten(like, leaf_fn, path=()):
    """Rebuild ``like``'s structure with ``leaf_fn(key, like_leaf)``."""
    items = _items(like)
    if items is None:
        return leaf_fn(SEP.join(path), like)
    vals = [_unflatten(child, leaf_fn, path + (part,))
            for part, child in items]
    if isinstance(like, dict):
        return dict(zip(sorted(like), vals))
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*vals)
    if isinstance(like, (tuple, list)):
        return type(like)(vals)
    return None


def _paths(ckpt_dir: str, step: int) -> tuple[str, str]:
    return (os.path.join(ckpt_dir, f"step_{step}.npz"),
            os.path.join(ckpt_dir, f"step_{step}.json"))


def _shard_path(ckpt_dir: str, step: int, r: int, n: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}.shard{r}of{n}.npz")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


class _HashingWriter:
    """Write-through file wrapper that hashes bytes as they stream past.

    It refuses to be seekable (``tell`` raises), which makes ``zipfile``
    switch to sequential data-descriptor writes instead of backpatching
    each member's local header: the bytes pass exactly once and the
    running sha256 equals a hash of the finished file, without
    re-reading it.
    """

    def __init__(self, f):
        self._f = f
        self._h = hashlib.sha256()

    def write(self, data) -> int:
        self._h.update(data)
        return self._f.write(data)

    def flush(self):
        self._f.flush()

    # ``read`` makes np.savez treat this as file-like; read and tell
    # raise so zipfile takes its non-seekable write path
    def read(self, *args):
        raise OSError("write-only hashing stream")

    def tell(self):
        raise OSError("non-seekable hashing stream")

    def seekable(self) -> bool:
        return False

    def hexdigest(self) -> str:
        return self._h.hexdigest()


def _write_npz_hashed(tmp_path: str, flat: dict) -> str:
    """Write ``flat`` to ``tmp_path``; returns the content sha256
    computed while writing."""
    with open(tmp_path, "wb") as f:
        hw = _HashingWriter(f)
        np.savez(hw, **flat)
    return hw.hexdigest()


def _rank_of(group) -> tuple[int, int]:
    return dist.get_rank(group), dist.get_world_size(group)


def _spec_replicated(tree, mesh, specs) -> tuple:
    """The keys of ``tree`` whose ``PartitionSpec`` leaves axis 0 whole
    on ``mesh``; a split over fewer than every rank raises."""
    by_key = dict(_walk(specs))
    out = []
    for key, x in _walk(tree):
        n = by_key[key].shards(mesh, 0) if np.ndim(x) else 1
        if n == 1:
            out.append(key)
        elif n != mesh.size:
            raise ValueError(f"{key}: split {n} ways on a process group of "
                             f"{mesh.size} ranks (a rank-written "
                             "checkpoint splits over every rank)")
    return tuple(out)


def mesh_save_kwargs(tree, mesh, specs) -> dict:
    """``save_checkpoint`` / ``AsyncCheckpointer.save`` keywords for
    ``tree`` on ``mesh``: on a process-group mesh every rank writes its
    block (``group``, ``n_shards`` the mesh's size, ``replicated`` the
    keys ``specs`` leave whole); on a one-process mesh none."""
    if mesh.group is None:
        return {}
    return {"group": mesh.group, "n_shards": mesh.size,
            "replicated": _spec_replicated(tree, mesh, specs)}


def save_checkpoint(ckpt_dir: str, step: int, tree, extra: dict | None = None,
                    n_shards: int = 1, replicated: tuple = (), *,
                    group=None):
    """Publish checkpoint ``step`` atomically; returns the npz path (shard
    0's with ``n_shards > 1``).

    With ``n_shards > 1`` every key whose top-level name (or whole key)
    is not in ``replicated`` is split into ``n_shards`` contiguous axis-0
    blocks, one per ``step_N.shard<r>of<R>.npz``; replicated keys and
    scalars are stored once, in shard 0, which is published last.

    With ``group`` (a ``torch.distributed`` process group of W ranks)
    ``tree`` is this rank's part: every split key holds the rank's
    ``n_shards / W`` contiguous blocks, rank r's starting at block
    ``r * n_shards / W``, and rank 0's tree holds the replicated keys.
    Every rank calls it (it is collective) and writes only its own
    files.  For a tree on a ``Mesh``, ``mesh_save_kwargs`` gives these
    keywords.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    out, man_out = _paths(ckpt_dir, step)
    man_tmp = os.path.join(ckpt_dir, f".tmp_step_{step}.json")
    if n_shards <= 1 and group is None:
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step}.npz")
        digest = _write_npz_hashed(tmp, flat)
        # the hash ties the manifest/npz PAIR together: a crash between
        # the two replaces of an overwritten step leaves a new manifest
        # with an old npz, which validate_checkpoint then rejects as torn
        manifest = {"step": step, "n_arrays": len(flat),
                    "npz_sha256": digest, **(extra or {})}
        with open(man_tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(man_tmp, man_out)       # manifest published first ...
        os.replace(tmp, out)               # ... npz last: the commit point
        return out

    rank, world = (0, 1) if group is None else _rank_of(group)
    if n_shards % world:
        raise ValueError(f"n_shards={n_shards} is not divisible by the "
                         f"group's {world} ranks")
    n_local = n_shards // world
    first = rank * n_local
    repl = set(replicated)
    shard_flats: dict[int, dict] = {first + i: {} for i in range(n_local)}
    for key, arr in flat.items():
        if key.split(SEP, 1)[0] in repl or key in repl or arr.ndim == 0:
            if first == 0:
                shard_flats[0][key] = arr
            continue
        if arr.shape[0] % n_local:
            raise ValueError(
                f"cannot shard {key!r}: axis-0 size {arr.shape[0]} not "
                f"divisible by n_shards={n_shards}")
        block = arr.shape[0] // n_local
        for i in range(n_local):
            shard_flats[first + i][key] = arr[i * block:(i + 1) * block]
    tmps, digests = {}, {}
    for r, fl in shard_flats.items():
        tmps[r] = os.path.join(ckpt_dir, f".tmp_step_{step}.shard{r}.npz")
        digests[r] = _write_npz_hashed(tmps[r], fl)
    n_arrays = len(shard_flats.get(0, {}))
    if group is not None:
        parts = [None] * world
        dist.all_gather_object(parts, (digests, n_arrays), group=group)
        digests = {r: d for part, _ in parts for r, d in part.items()}
        n_arrays = parts[0][1]
    if rank == 0:
        manifest = {"step": step, "n_arrays": n_arrays,
                    "shards": {"n": n_shards,
                               "sha256": [digests[r]
                                          for r in range(n_shards)]},
                    **(extra or {})}
        with open(man_tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(man_tmp, man_out)       # manifest first ...
    _barrier(group)
    for r in sorted(tmps, reverse=True):   # ... shard 0 last: commit point
        if r:
            os.replace(tmps[r], _shard_path(ckpt_dir, step, r, n_shards))
    _barrier(group)
    if 0 in tmps:
        os.replace(tmps[0], _shard_path(ckpt_dir, step, 0, n_shards))
    _barrier(group)
    return _shard_path(ckpt_dir, step, 0, n_shards)


def _barrier(group) -> None:
    if group is not None:
        dist.barrier(group=group)


def _delta_prev(manifest: dict) -> int | None:
    """The previous step a delta manifest chains to (``None`` if the
    manifest is self-contained)."""
    for k, v in manifest.items():
        if k.endswith("_delta") and isinstance(v, dict) and "prev" in v:
            return int(v["prev"])
    return None


def prune_checkpoints(ckpt_dir: str, keep_last: int) -> list[int]:
    """Delete all but the newest ``keep_last`` published checkpoints;
    returns the pruned step ids.

    Delta-chain aware: arrays of pruned steps always go, but a pruned
    step's JSON manifest survives while any kept step's delta chain
    still references it."""
    if keep_last <= 0:
        raise ValueError("keep_last must be positive")
    steps = checkpoint_steps(ckpt_dir)
    pruned, kept = steps[:-keep_last], steps[-keep_last:]
    needed: set[int] = set()
    for s in kept:
        cur: int | None = s
        while cur is not None and cur not in needed:
            needed.add(cur)
            try:
                cur = _delta_prev(load_manifest(ckpt_dir, cur))
            except CheckpointError:
                break
    for step in pruned:
        npz, _ = _paths(ckpt_dir, step)
        for path in [npz] + _shard_files(ckpt_dir, step):
            try:
                os.remove(path)
            except OSError:
                pass
    # every manifest not referenced by a kept step's chain goes,
    # including ones orphaned by earlier prunes
    keep_man = needed | set(kept)
    for f in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)\.json", f)
        if m and int(m.group(1)) not in keep_man:
            try:
                os.remove(os.path.join(ckpt_dir, f))
            except OSError:
                pass
    return pruned


def _shard_files(ckpt_dir: str, step: int) -> list[str]:
    if not os.path.isdir(ckpt_dir):
        return []
    pat = re.compile(rf"step_{step}\.shard\d+of\d+\.npz")
    return [os.path.join(ckpt_dir, f) for f in os.listdir(ckpt_dir)
            if pat.fullmatch(f)]


def checkpoint_steps(ckpt_dir: str) -> list[int]:
    """All steps with published arrays, ascending (not validated).  A
    sharded step is listed once its shard-0 file, the commit point, is
    visible."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted({int(m.group(1)) for f in os.listdir(ckpt_dir)
                   if (m := re.fullmatch(
                       r"step_(\d+)(?:\.shard0of\d+)?\.npz", f))})


def validate_checkpoint(ckpt_dir: str, step: int) -> None:
    """Raise ``CheckpointError`` if checkpoint ``step`` is torn/partial.

    The JSON manifest must exist and parse, and the ``.npz`` (or every
    shard of a sharded step) must be byte-identical to what
    ``save_checkpoint`` wrote (``npz_sha256``, ``shards.sha256``); a
    manifest without a hash (foreign writer) falls back to a zip CRC
    scan.
    """
    npz, man = _paths(ckpt_dir, step)
    try:
        with open(man) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(f"step {step}: bad manifest {man}: {e}") from e
    shards = manifest.get("shards")
    if shards is not None:
        n = int(shards["n"])
        for r, want in enumerate(shards["sha256"]):
            path = _shard_path(ckpt_dir, step, r, n)
            try:
                got = _sha256(path)
            except OSError as e:
                raise CheckpointError(
                    f"step {step}: missing shard {path}: {e}") from e
            if got != want:
                raise CheckpointError(
                    f"step {step}: shard {r}/{n} does not match its "
                    "manifest hash (torn write?)")
        return
    want = manifest.get("npz_sha256")
    try:
        if want is not None:
            if want != _sha256(npz):
                raise CheckpointError(
                    f"step {step}: manifest does not match {npz} "
                    "(torn write, or crash while overwriting the step?)")
        else:
            with zipfile.ZipFile(npz) as z:
                bad = z.testzip()
                if bad is not None:
                    raise CheckpointError(
                        f"step {step}: corrupt member {bad!r} in {npz}")
    except (zipfile.BadZipFile, OSError, EOFError) as e:
        raise CheckpointError(f"step {step}: torn archive {npz}: {e}") from e


def latest_step(ckpt_dir: str, validate: bool = True) -> int | None:
    """Newest usable checkpoint step (``None`` if there is none); with
    ``validate``, torn/partial checkpoints are skipped."""
    steps = checkpoint_steps(ckpt_dir)
    if not validate:
        return steps[-1] if steps else None
    for step in reversed(steps):
        try:
            validate_checkpoint(ckpt_dir, step)
            return step
        except CheckpointError:
            continue
    return None


def load_manifest(ckpt_dir: str, step: int) -> dict:
    """The JSON manifest written alongside ``step``'s arrays."""
    _, man = _paths(ckpt_dir, step)
    try:
        with open(man) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(f"step {step}: bad manifest {man}: {e}") from e


# --------------------------------------------------------------------- #
# Incremental manifests: base + per-step deltas
# --------------------------------------------------------------------- #
# Patch format (JSON-safe):
#   {"__deleted__": true}   delete this key
#   {"__replace__": v}      set this key to the literal value v
#   any other dict          recurse (nested patch)
#   any non-dict value      set this key to the value
def dict_diff(old: dict, new: dict) -> dict:
    """Minimal patch such that ``apply_patch(old, patch) == new``."""
    patch: dict = {}
    for k in old:
        if k not in new:
            patch[k] = {"__deleted__": True}
    for k, v in new.items():
        if k in old:
            ov = old[k]
            if ov == v:
                continue
            if isinstance(ov, dict) and isinstance(v, dict):
                sub = dict_diff(ov, v)
                if sub:
                    patch[k] = sub
                continue
        patch[k] = {"__replace__": v} if isinstance(v, dict) else v
    return patch


def apply_patch(base: dict, patch: dict) -> dict:
    out = dict(base)
    for k, v in patch.items():
        if isinstance(v, dict):
            if v.get("__deleted__") is True and len(v) == 1:
                out.pop(k, None)
            elif "__replace__" in v and len(v) == 1:
                out[k] = v["__replace__"]
            else:
                out[k] = apply_patch(
                    out.get(k, {}) if isinstance(out.get(k), dict) else {}, v)
        else:
            out[k] = v
    return out


def load_resolved_manifest(ckpt_dir: str, step: int, key: str) -> dict:
    """Resolve ``manifest[key]`` at ``step``, replaying delta manifests
    (``{key}_delta = {"prev": step, "patch": {...}}``) back to the
    nearest full base.  A torn chain is counted in ``N_DELTA_FALLBACKS``,
    warned about, and raised as ``CheckpointError`` so restore loops
    fall back to the last compacted base still on disk."""
    global N_DELTA_FALLBACKS
    patches: list[dict] = []
    seen: set[int] = set()
    cur = step
    while True:
        if cur in seen:
            raise CheckpointError(
                f"step {step}: delta manifest chain loops at {cur}")
        seen.add(cur)
        try:
            man = load_manifest(ckpt_dir, cur)
        except CheckpointError:
            if patches:          # torn mid-chain, not just a bad head
                N_DELTA_FALLBACKS += 1
                warnings.warn(
                    f"checkpoint step {step}: delta chain torn at step "
                    f"{cur}; falling back (N_DELTA_FALLBACKS="
                    f"{N_DELTA_FALLBACKS})", stacklevel=2)
            raise
        if key in man:
            base = man[key]
            break
        delta = man.get(f"{key}_delta")
        if delta is None:
            raise CheckpointError(
                f"step {cur}: manifest has neither {key!r} nor "
                f"'{key}_delta'")
        patches.append(delta["patch"])
        cur = int(delta["prev"])
    for patch in reversed(patches):
        base = apply_patch(base, patch)
    return base


class _Arrays:
    """The global arrays of checkpoint ``step``, read lazily from its
    single ``.npz`` or its shard files (a key present in shard 1 is split
    along axis 0 in shard order; a shard-0-only key is replicated)."""

    def __init__(self, ckpt_dir: str, step: int):
        self.step = step
        npz, _ = _paths(ckpt_dir, step)
        self.where = npz
        try:
            self.files = [np.load(npz)]
            return
        except (OSError, zipfile.BadZipFile, ValueError, EOFError) as e:
            shards = _shard_files(ckpt_dir, step)
            if not shards:
                raise CheckpointError(
                    f"step {step}: unreadable {npz}: {e}") from e
        m = re.search(r"shard\d+of(\d+)\.npz", os.path.basename(shards[0]))
        n = int(m.group(1))
        self.files = []
        for r in range(n):
            path = _shard_path(ckpt_dir, step, r, n)
            try:
                self.files.append(np.load(path))
            except (OSError, zipfile.BadZipFile, ValueError, EOFError) as e:
                raise CheckpointError(
                    f"step {step}: unreadable shard {path}: {e}") from e
        self.where = shards[0]

    def _read(self, r: int, key: str) -> np.ndarray:
        try:
            return self.files[r][key]
        except KeyError as e:
            raise ValueError(
                f"step {self.step}: array {key!r} missing from "
                f"{self.where} (state schema drift?)") from e
        except (zipfile.BadZipFile, OSError, ValueError, EOFError) as e:
            raise CheckpointError(
                f"step {self.step}: unreadable array {key!r}: {e}") from e

    def split(self, key: str) -> bool:
        return len(self.files) > 1 and key in self.files[1].files

    def whole(self, key: str) -> np.ndarray:
        if not self.split(key):
            return self._read(0, key)
        return np.concatenate([self._read(r, key)
                               for r in range(len(self.files))], axis=0)

    def rows(self, key: str, lo: int, hi: int, total: int) -> np.ndarray:
        """Global rows ``[lo, hi)`` of ``key``, whose axis 0 must be
        ``total`` long; reads only the shard files that hold them."""
        if not self.split(key):
            arr = self._read(0, key)
            if arr.shape[0] != total:
                raise ValueError(f"shape mismatch for {key}: axis 0 of "
                                 f"{arr.shape} vs {total}")
            return arr[lo:hi]
        first = self._read(0, key)
        b = first.shape[0]
        if b * len(self.files) != total:
            raise ValueError(f"shape mismatch for {key}: {len(self.files)} "
                             f"shards of {b} rows vs {total}")
        parts = [first if r == 0 else self._read(r, key)
                 for r in range(lo // b, -(-hi // b))]
        off = (lo // b) * b
        return np.concatenate(parts, axis=0)[lo - off:hi - off]


def _place(arr: np.ndarray, like, device=None):
    """``arr`` as ``like`` holds it: a tensor of its dtype on its device
    (or ``device``), else a numpy array of its dtype."""
    if torch.is_tensor(like):
        return torch.as_tensor(arr).to(
            device=like.device if device is None else device,
            dtype=like.dtype)
    return arr.astype(np.asarray(like).dtype)


def restore_checkpoint(ckpt_dir: str, step: int, like_tree,
                       mesh=None, specs=None):
    """Restore into the structure of ``like_tree``.

    A tensor leaf of ``like_tree`` comes back as a tensor of its dtype on
    its device; any other leaf as a numpy array of its dtype.  A torn
    file raises ``CheckpointError`` (callers fall back to an older step);
    a missing array or a shape mismatch raises ``ValueError``: the npz
    publishes atomically, so either means the caller's state schema
    drifted — a configuration error that must be loud.  A sharded step
    is reassembled on the host, whatever the number of replicas or
    ranks that wrote it.

    With ``mesh`` and ``specs`` the restored tree goes through
    ``reshard``: every leaf a tensor on the mesh's device, in the
    reference's global shape.  That places an engine state back at the
    shard count it was written with; onto another count, pass it through
    ``repro_torch.runtime.elastic.scale_to_mesh``.  On a process-group
    mesh ``like_tree`` is this rank's part (``build_sharded_tick``'s
    state) and so is the result: each rank reads its own rows of every
    split key, from the files that hold them.
    """
    if (mesh is None) != (specs is None):
        raise ValueError("restore_checkpoint needs both mesh= and specs=, "
                         "or neither")
    data = _Arrays(ckpt_dir, step)
    if mesh is not None and mesh.group is not None:
        by_key = dict(_walk(specs))

        def rank_leaf(key, like):
            n = by_key[key].shards(mesh, 0) if like.ndim else 1
            shape = tuple(like.shape)
            if n == 1:
                arr = data.whole(key)
                if arr.shape != shape:
                    raise ValueError(f"shape mismatch for {key}: "
                                     f"{arr.shape} vs {shape}")
            else:
                c = shape[0]
                arr = data.rows(key, mesh.rank * c, (mesh.rank + 1) * c,
                                c * n)
                if arr.shape[1:] != shape[1:]:
                    raise ValueError(f"shape mismatch for {key}: "
                                     f"{arr.shape} vs {shape}")
            return _place(arr, like, mesh.device)

        return _unflatten(like_tree, rank_leaf)

    def leaf(key, like):
        arr = data.whole(key)
        shape = tuple(like.shape)
        if arr.shape != shape:
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {shape}")
        return _place(arr, like)

    tree = _unflatten(like_tree, leaf)
    return tree if mesh is None else reshard(tree, mesh, specs)


def reshard(tree, mesh, specs):
    """Place ``tree`` onto ``mesh`` under the ``PartitionSpec`` tree
    ``specs`` (the same structure): every leaf becomes a tensor of its
    dtype on the mesh's device, in its global shape.  An axis that a
    spec splits over mesh axes must divide by their product
    (``ValueError`` otherwise).  On a process-group mesh ``tree`` is
    global (on the host or any device) and each rank keeps its block of
    every split axis 0: rows ``[r*C/n, (r+1)*C/n)``."""
    by_key = dict(_walk(specs))

    def leaf(key, x):
        try:
            spec = by_key[key]
        except KeyError as e:
            raise ValueError(f"no PartitionSpec for {key!r}") from e
        x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        for dim in range(x.dim()):
            n = spec.shards(mesh, dim)
            if x.shape[dim] % n:
                raise ValueError(
                    f"{key}: axis {dim} of {tuple(x.shape)} is not "
                    f"divisible by {n} shards ({spec})")
        if mesh.group is not None and x.dim() and spec.shards(mesh, 0) > 1:
            n = spec.shards(mesh, 0)
            if n != mesh.size:
                raise ValueError(f"{key}: split {n} ways on a process "
                                 f"group of {mesh.size} ranks")
            c = x.shape[0] // n
            x = x[mesh.rank * c:(mesh.rank + 1) * c]
        return x.to(mesh.device)

    return _unflatten(tree, leaf)


class AsyncCheckpointer:
    """Non-blocking checkpoint writer (single background thread, FIFO)."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._lock = threading.Lock()
        self._pending = []
        # cumulative seconds wait() spent blocked on unfinished writes
        # (the ``ckpt.stall_s`` gauge)
        self.stall_s = 0.0
        # seconds the writer thread spent in its last write (file +
        # prune); read after ``wait``
        self.last_write_s = 0.0

    def save(self, step: int, tree, extra: dict | None = None,
             keep_last: int | None = None, n_shards: int = 1,
             replicated: tuple = (), *, group=None):
        """Snapshot ``tree`` to host memory now, write it on the writer
        thread.  With ``keep_last``, older checkpoints are pruned on the
        writer thread after the new step publishes.  ``n_shards`` /
        ``replicated`` pass through to ``save_checkpoint`` (per-replica
        shard files for the mesh service).

        With ``group`` (``tree`` this rank's part, see
        ``save_checkpoint``) the save is written and published here, in
        the caller's thread: its hash exchange and barriers are
        collectives, which every rank must issue in one order with the
        rest of its collectives (a tick's among them).  Rank 0 prunes.
        Returns a finished future."""
        host = _flatten(tree)              # synchronous owned snapshot

        def _write():
            t0 = time.perf_counter()
            out = save_checkpoint(self.ckpt_dir, step, host, extra,
                                  n_shards=n_shards, replicated=replicated,
                                  group=group)
            if keep_last is not None and (group is None
                                          or _rank_of(group)[0] == 0):
                prune_checkpoints(self.ckpt_dir, keep_last)
            self.last_write_s = time.perf_counter() - t0
            return out

        if group is not None:
            self.wait()
            fut = Future()
            fut.set_result(_write())
            return fut
        fut = self._pool.submit(_write)
        with self._lock:
            self._pending.append(fut)
        return fut

    def wait(self):
        with self._lock:
            pending, self._pending = self._pending, []
        blocked = [f for f in pending if not f.done()]
        t0 = time.perf_counter() if blocked else 0.0
        for f in pending:
            f.result()
        if blocked:
            self.stall_s += time.perf_counter() - t0
