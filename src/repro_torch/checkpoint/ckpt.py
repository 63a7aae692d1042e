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

The async writer copies every tensor to host memory synchronously before
``save`` returns (the service's slot tables are updated in place by the
next tick, so the snapshot must not alias them), then writes the file on
a background thread.

Sharded (per-replica) checkpoints and ``reshard`` belong to the mesh
slice of the port and raise ``NotImplementedError``.
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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEP = "::"

# Torn-delta fallbacks observed by load_resolved_manifest in this
# process (a delta manifest chain that could not be replayed).
N_DELTA_FALLBACKS = 0

_MESH = ("sharded checkpoints (n_shards > 1) and reshard belong to the "
         "mesh slice of the port")


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


def save_checkpoint(ckpt_dir: str, step: int, tree, extra: dict | None = None,
                    n_shards: int = 1, replicated: tuple = ()):
    """Publish checkpoint ``step`` atomically; returns the npz path."""
    if n_shards > 1:
        raise NotImplementedError(_MESH)
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    out, man_out = _paths(ckpt_dir, step)
    man_tmp = os.path.join(ckpt_dir, f".tmp_step_{step}.json")
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}.npz")
    digest = _write_npz_hashed(tmp, flat)
    # the hash ties the manifest/npz PAIR together: a crash between the
    # two replaces of an overwritten step leaves a new manifest with an
    # old npz, which validate_checkpoint then rejects as torn
    manifest = {"step": step, "n_arrays": len(flat),
                "npz_sha256": digest, **(extra or {})}
    with open(man_tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(man_tmp, man_out)       # manifest published first ...
    os.replace(tmp, out)               # ... npz last: the commit point
    return out


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
        try:
            os.remove(npz)
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


def checkpoint_steps(ckpt_dir: str) -> list[int]:
    """All steps with published arrays, ascending (not validated).  A
    sharded step (written by the reference's mesh service) is listed
    once its shard-0 file is visible."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted({int(m.group(1)) for f in os.listdir(ckpt_dir)
                   if (m := re.fullmatch(
                       r"step_(\d+)(?:\.shard0of\d+)?\.npz", f))})


def validate_checkpoint(ckpt_dir: str, step: int) -> None:
    """Raise ``CheckpointError`` if checkpoint ``step`` is torn/partial.

    The JSON manifest must exist and parse, and the ``.npz`` must be
    byte-identical to what ``save_checkpoint`` wrote (``npz_sha256``); a
    manifest without a hash (foreign writer) falls back to a zip CRC
    scan.
    """
    npz, man = _paths(ckpt_dir, step)
    try:
        with open(man) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(f"step {step}: bad manifest {man}: {e}") from e
    if manifest.get("shards") is not None:
        raise NotImplementedError(_MESH)
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


def restore_checkpoint(ckpt_dir: str, step: int, like_tree,
                       mesh=None, specs=None):
    """Restore into the structure of ``like_tree``.

    A tensor leaf of ``like_tree`` comes back as a tensor of its dtype on
    its device; any other leaf as a numpy array of its dtype.  A torn
    file raises ``CheckpointError`` (callers fall back to an older step);
    a missing array or a shape mismatch raises ``ValueError``: the npz
    publishes atomically, so either means the caller's state schema
    drifted — a configuration error that must be loud.
    """
    if mesh is not None or specs is not None:
        raise NotImplementedError(_MESH)
    npz, _ = _paths(ckpt_dir, step)
    try:
        data = np.load(npz)
    except (OSError, zipfile.BadZipFile, ValueError, EOFError) as e:
        raise CheckpointError(f"step {step}: unreadable {npz}: {e}") from e

    def leaf(key, like):
        try:
            arr = data[key]
        except KeyError as e:
            raise ValueError(
                f"step {step}: array {key!r} missing from {npz} "
                "(state schema drift?)") from e
        except (zipfile.BadZipFile, OSError, ValueError, EOFError) as e:
            raise CheckpointError(
                f"step {step}: unreadable array {key!r}: {e}") from e
        shape = tuple(like.shape)
        if arr.shape != shape:
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {shape}")
        if torch.is_tensor(like):
            return torch.as_tensor(arr).to(device=like.device,
                                           dtype=like.dtype)
        return arr.astype(np.asarray(like).dtype)

    return _unflatten(like_tree, leaf)


def reshard(tree, mesh, specs):
    raise NotImplementedError(_MESH)


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
             replicated: tuple = ()):
        """Snapshot ``tree`` to host memory now, write it on the writer
        thread.  With ``keep_last``, older checkpoints are pruned on the
        writer thread after the new step publishes."""
        if n_shards > 1:
            raise NotImplementedError(_MESH)
        host = _flatten(tree)              # synchronous owned snapshot

        def _write():
            t0 = time.perf_counter()
            out = save_checkpoint(self.ckpt_dir, step, host, extra)
            if keep_last is not None:
                prune_checkpoints(self.ckpt_dir, keep_last)
            self.last_write_s = time.perf_counter() - t0
            return out

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
