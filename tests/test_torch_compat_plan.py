"""The CUDA compat-join kernels' host side, on the CPU.

The kernels themselves run only on the card (``tests/test_torch_gpu.py``);
what they are given is plain Python that the CPU reaches:

* the launch plan (``kernel.plan``): the instantiation, tiles, grids
  within the card's limits, shared memory and scratch sizes, slot
  strides, and the int64 array in the order of the source's ``P_*`` enum;
* the spec encoding (``kernel.encode_spec``): the predicate evaluated in
  numpy from the encoded bit masks, the way the kernel evaluates it (TREL
  as per-column thresholds, the window span wrapping in int32), must
  equal ``compat_mask_ref`` for every join spec of the plan-check corpus,
  the serving tenants and the test fixtures;
* the constants and tables that the plan shares with the source.
"""

import re

import numpy as np
import pytest
import torch

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.analysis.plan_check import _corpus_queries
from repro_torch.core.join import compat_mask_ref
from repro_torch.core.plan import compile_plan
from repro_torch.core.query import QueryGraph
from repro_torch.kernels.compat_join import kernel as K

SRC = K.SOURCE.read_text()
ALL = (True,) * 6
LEVEL_STACKED = (True, True, True, False, False, True)   # shared batch


def _define(name: str) -> str:
    return re.search(rf"#define {name} (.+?)(\s*//.*)?$", SRC, re.M).group(1)


def _tenants():
    """The two structures ``chip_smoke.py`` serves: a timed 3-edge chain
    and a two-chain (two 2-edge chains from one vertex)."""
    yield "chain", QueryGraph(4, (0, 1, 2, 3), ((0, 1), (1, 2), (2, 3)),
                              edge_labels=(0, 1, 2),
                              prec=frozenset({(0, 1), (1, 2)}))
    yield "two_chain", QueryGraph(
        5, (0, 1, 2, 3, 4), ((0, 1), (1, 2), (0, 3), (3, 4)),
        edge_labels=(0, 1, 2, 3), prec=frozenset({(0, 1), (2, 3)}))


def _join_specs(plan):
    """Every (rel, trel) the engine joins with under ``plan``: each level
    join (REL of the previous layout against the new edge's endpoints,
    TREL: A's last edge before B's; as ``engine.build_tick_body`` builds
    them) and each L0 join."""
    for s in plan.subqueries:
        for li in range(1, len(s.levels)):
            lv = s.levels[li]
            rel = np.zeros((len(s.levels[li - 1].vertex_layout), 2), bool)
            if lv.src_slot >= 0:
                rel[lv.src_slot, 0] = True
            if lv.dst_slot >= 0:
                rel[lv.dst_slot, 1] = True
            trel = np.zeros((li, 1), np.int8)
            trel[li - 1, 0] = -1
            yield rel, trel
    for js in plan.l0_joins:
        yield js.rel, js.trel


def _plans():
    for name, q in list(_corpus_queries()) + list(_tenants()):
        for window in (25, 1000):
            yield f"{name}@{window}", compile_plan(q, window)


FIXTURES = [   # the specs the port's join tests use
    (np.array([[False, False], [True, False]]), np.array([[-1]], np.int8)),
    (np.eye(3, dtype=bool) * np.array([1, 0, 0], bool),
     np.array([[0, -1], [1, 0]], np.int8)),
    (np.array([[True, False, False], [False, False, True]]),
     np.array([[-1, 0], [0, 1]], np.int8)),
    (np.zeros((3, 3), bool), np.zeros((2, 2), np.int8)),
    (np.array([[True, True], [True, False]]),          # both a's == b_0
     np.array([[-1, 1], [1, -1]], np.int8)),
    (np.ones((5, 3), bool), np.full((2, 2), -1, np.int8)),
]


def _all_specs():
    seen = {}
    for name, plan in _plans():
        for rel, trel in _join_specs(plan):
            seen.setdefault((rel.shape, rel.tobytes(), trel.shape,
                             trel.tobytes()), (name, rel, trel))
    for k, (rel, trel) in enumerate(FIXTURES):
        seen.setdefault((rel.shape, rel.tobytes(), trel.shape,
                         trel.tobytes()), (f"fixture{k}", rel, trel))
    return list(seen.values())


SPECS = _all_specs()


# --------------------------------------------------------------------- #
# The spec encoding.
# --------------------------------------------------------------------- #
def _wrap32(x):
    return ((x + 2**31) % 2**32 - 2**31).astype(np.int64)


def mask_from_words(spec, tables, window):
    """The join mask evaluated from the encoded spec alone, as the kernel
    does: REL per B vertex column j, one compare against the first A
    binding with an eq bit where the column has one (qcol; the row's other
    bindings checked against that value once per row), else one "must
    differ" compare per ne bit; TREL as inclusive bounds per B timestamp
    column j (ets_b[j] above the largest ets_a[i] with an lt bit and below
    the smallest with a gt bit); the window on the int32
    (wrapping) span of all timestamps.  Tables are slot-stacked."""
    w = spec.words

    def bit(block, k):
        return (w[8 * block + k // 32] >> (k % 32)) & 1

    ba, ea, va, bb, eb, vb = (np.asarray(t, dtype=np.int64)
                              for t in tables)
    nva, nvb, nea, neb = spec.nva, spec.nvb, spec.nea, spec.neb
    ok = (va[:, :, None] != 0) & (vb[:, None, :] != 0)
    for j in range(nvb):
        eq = [i for i in range(nva) if bit(0, i * nvb + j)]
        ne = [i for i in range(nva) if bit(1, i * nvb + j)]
        assert bool(eq) == bool((w[34] >> j) & 1)
        bj = bb[:, None, :, j]
        if eq:
            # one compare against v = the first eq binding; the row's own
            # bindings decide the rest of the column once per row
            v = ba[:, :, eq[0]]
            alive = np.ones_like(v, dtype=bool)
            for i in eq:
                alive &= ba[:, :, i] == v
            for i in ne:
                alive &= ba[:, :, i] != v
            ok &= alive[:, :, None] & (bj == v[:, :, None])
        else:
            for i in ne:
                ok &= bj != ba[:, :, i, None]
    i32 = np.iinfo(np.int32)
    for j in range(neb):
        tj = eb[:, None, :, j]
        lt = [i for i in range(nea) if bit(2, i * neb + j)]
        gt = [i for i in range(nea) if bit(3, i * neb + j)]
        assert bool(lt) == bool((w[32] >> j) & 1)
        assert bool(gt) == bool((w[33] >> j) & 1)
        # inclusive bounds: b > lo is b >= lo + 1, b < hi is b <= hi - 1;
        # a bound that no int32 meets leaves the row no match
        lo = ea[:, :, lt].max(axis=2) if lt else None
        hi = ea[:, :, gt].min(axis=2) if gt else None
        tlo = lo + 1 if lt else np.full(ea.shape[:2], i32.min)
        thi = hi - 1 if gt else np.full(ea.shape[:2], i32.max)
        alive = (tlo <= i32.max) & (thi >= i32.min)
        ok &= alive[:, :, None] & (tj >= tlo[:, :, None]) \
            & (tj <= thi[:, :, None])
    if window is not None:
        span = _wrap32(np.maximum(ea.max(2)[:, :, None], eb.max(2)[:, None])
                       - np.minimum(ea.min(2)[:, :, None],
                                    eb.min(2)[:, None]))
        ok &= span < np.asarray(window, np.int64)[:, None, None]
    return ok


def _tables(rng, rel, trel, n_slots=2, ca=40, cb=60, wrap=False):
    nva, nvb = rel.shape
    nea, neb = trel.shape
    n_v = 3 * max(nva, nvb)
    if wrap:          # timestamps on both sides of the int32 wrap
        ea = rng.integers(2**31 - 40, 2**31, (n_slots, ca, nea))
        eb = rng.integers(-2**31, -2**31 + 40, (n_slots, cb, neb))
        ea, eb = ea.astype(np.int32), eb.astype(np.int32)
    else:
        ea = rng.integers(0, 40, (n_slots, ca, nea), dtype=np.int32)
        eb = rng.integers(10, 50, (n_slots, cb, neb), dtype=np.int32)
    return (rng.integers(0, n_v, (n_slots, ca, nva), dtype=np.int32), ea,
            rng.random((n_slots, ca)) < 0.8,
            rng.integers(0, n_v, (n_slots, cb, nvb), dtype=np.int32), eb,
            rng.random((n_slots, cb)) < 0.8)


def test_specs_cover_the_corpus_and_the_serving_shapes():
    shapes = {(r.shape + t.shape) for _, r, t in SPECS}
    assert {(2, 2, 1, 1), (3, 2, 2, 1), (3, 3, 2, 2)} <= shapes
    # every join shape of the corpus and the tenants has its own
    # instantiation; the fixtures add shapes off the list
    for name, plan in _plans():
        for rel, trel in _join_specs(plan):
            assert rel.shape + trel.shape in K.SHAPES, name
    assert len(SPECS) >= 12


@pytest.mark.parametrize("window", [None, "per_slot", "wrap"])
@pytest.mark.parametrize("name,rel,trel", SPECS, ids=[s[0] for s in SPECS])
def test_encoded_spec_predicate_equals_compat_mask_ref(name, rel, trel,
                                                       window):
    rng = np.random.default_rng(len(name) * 7 + rel.size)
    tables = _tables(rng, rel, trel, wrap=window == "wrap")
    wins = None if window is None else \
        rng.integers(5, 30, 2).astype(np.int32)
    spec = K.encode_spec(rel, trel)
    want = compat_mask_ref(*(torch.as_tensor(t) for t in tables), rel, trel,
                           None if wins is None else torch.as_tensor(wins))
    got = mask_from_words(spec, tables, wins)
    assert np.array_equal(got, want.numpy()), name


def test_spec_words_and_cache():
    rel, trel = FIXTURES[2]
    spec = K.encode_spec(rel, trel)
    # rel[0][0] and rel[1][2] must be equal (bits 0 and 5), the rest
    # differ; trel[0][0] = -1 (lt bit 0, column 0), trel[1][1] = +1 (gt
    # bit 3, column 1)
    assert spec.words[0] == 0b100001 and spec.words[8] == 0b011110
    assert spec.words[16] == 0b1 and spec.words[24] == 0b1000
    assert (spec.words[32], spec.words[33]) == (0b01, 0b10)
    assert spec.words[34] == 0b101             # rel columns 0 and 2
    assert list(spec.c_words) == list(spec.words)
    assert len(spec.words) == K.SPEC_WORDS
    # cached by content: the same object for the same arrays, whatever
    # their dtype
    assert K.encode_spec(rel.astype(np.int32), trel.astype(np.int64)) \
        is spec
    big = K.encode_spec(np.ones((16, 16), bool), np.ones((16, 16), np.int8))
    assert big.words[:8] == (0xffffffff,) * 8 and big.words[33] == 0xffff
    with pytest.raises(ValueError, match="maxima"):
        K.encode_spec(np.ones((17, 2), bool), np.zeros((1, 1), np.int8))


# --------------------------------------------------------------------- #
# The launch plan.
# --------------------------------------------------------------------- #
PLAN_CASES = [   # kind, S, CA, CB, dims, stacked, window, max_new
    # the serving path's joins (chip_smoke's kernel and mask cases)
    (K.PAIRS, 8, 65536, 4096, (2, 2, 1, 1), LEVEL_STACKED, True, 8192),
    (K.PAIRS, 8, 8192, 65536, (3, 3, 2, 2), ALL, True, 8192),
    (K.PAIRS, 8, 65536, 8192, (3, 3, 2, 2), ALL, False, 8192),
    (K.PAIRS, 1, 65536, 4096, (2, 2, 1, 1), LEVEL_STACKED, False, 8192),
    (K.PAIRS, 8, 65536, 4096, (3, 2, 2, 1), LEVEL_STACKED, True, 8192),
    (K.MASK, 8, 8192, 65536, (3, 3, 2, 2), ALL, True, 0),
    (K.MASK, 1, 65536, 4096, (2, 2, 1, 1), LEVEL_STACKED, True, 0),
    # off the list, ragged, tiny, wide
    (K.PAIRS, 3, 77, 5000, (5, 3, 2, 2), ALL, True, 100),
    (K.MASK, 3, 77, 5000, (5, 3, 2, 2), ALL, False, 0),
    (K.PAIRS, 2, 1, 17, (2, 2, 1, 1), ALL, False, 0),
    (K.MASK, 2, 33, 17, (3, 2, 2, 1), ALL, False, 0),
    (K.PAIRS, 1, 100, 3000, (16, 16, 16, 16), ALL, True, 7),
    (K.MASK, 65535, 3, 1_000_000, (16, 16, 16, 16), ALL, True, 0),
]


@pytest.mark.parametrize("kind,s,ca,cb,dims,stacked,window,max_new",
                         PLAN_CASES)
def test_launch_plan(kind, s, ca, cb, dims, stacked, window, max_new):
    p = K.plan(kind, s, ca, cb, *dims, stacked, window, max_new)
    nva, nvb, nea, neb = dims
    # the instantiation: specialised where the shape is on the list
    if dims in K.SHAPES:
        assert p.shape == K.SHAPES.index(dims) and p.r == K.ROWS_PER_WARP
    else:
        assert p.shape == K.RUNTIME_DIMS and p.r == 1
    # tiles: whole mask windows; the widest whose staged tile fits
    assert p.tb in K.TILE_COLS and p.tb % K.WIN == 0
    assert K.tile_bytes(nvb, neb, p.tb) <= K.TILE_BYTES_MAX \
        or p.tb == K.TILE_COLS[-1]
    wider = [t for t in K.TILE_COLS if t > p.tb]
    assert all(K.tile_bytes(nvb, neb, t) > K.TILE_BYTES_MAX for t in wider)
    # A tiles: the most rows whose staged bindings and timestamps fit
    assert p.at in K.A_ROWS
    assert K.atile_bytes(nva, nea, p.at) <= K.A_TILE_BYTES_MAX \
        or p.at == K.A_ROWS[-1]
    assert all(K.atile_bytes(nva, nea, n) > K.A_TILE_BYTES_MAX
               for n in K.A_ROWS if n > p.at)
    # grids cover the tables and stay within the card's limits
    assert (p.nt - 1) * p.tb < cb <= p.nt * p.tb
    assert (p.nrt - 1) * p.at < ca <= p.nrt * p.at
    assert p.nt <= 65535 and p.slots == s <= 65535 and p.nrt < 2**31
    # shared memory: the source's formula, within a block's limit
    assert p.smem == K.smem_bytes(kind, nva, nvb, nea, neb, p.tb, p.at)
    assert p.smem <= K.SMEM_LIMIT
    if kind == K.PAIRS:
        assert p.smem == 4 * p.at + 4 * (nva + nea) * p.at \
            + 4 * (nvb + neb + 3) * p.tb
        # counts and offsets per (slot, A row, B tile), block sums per
        # (slot, A tile, B tile)
        assert p.scratch == 2 * s * ca * p.nt + s * p.nrt * p.nt
        assert p.max_new == max_new
    else:
        assert p.scratch == 0 and p.max_new == 0
        assert p.smem == K.tile_bytes(nvb, neb, p.tb) \
            + 4 * (nva + nea) * p.at + p.at + 4 * (p.tb // K.WIN + 1)
    # slot strides: a row's elements times the rows, 0 where shared
    per_slot = (ca * nva, ca * nea, ca, cb * nvb, cb * neb, cb)
    strides = (p.sa_bind, p.sa_ets, p.sa_valid, p.sb_bind, p.sb_ets,
               p.sb_valid)
    assert strides == tuple(n if st else 0
                            for n, st in zip(per_slot, stacked))
    assert p.window == int(window)
    assert list(p.c_args) == [getattr(p, f) for f in K.PLAN_FIELDS]


def test_launch_plan_serving_shapes():
    """The level join of a slot group: 64 A tiles x 4 B tiles x 8 slots,
    16 MB of scratch; the L0 J1 mask: 8 x 64 x 8 blocks."""
    lvl = K.plan(K.PAIRS, 8, 65536, 4096, 2, 2, 1, 1, LEVEL_STACKED, True,
                 8192)
    assert (lvl.shape, lvl.tb, lvl.at, lvl.nrt, lvl.nt) == (0, 1024, 1024,
                                                           64, 4)
    assert lvl.smem == 4096 + 12 * 1024 + 24 * 1024
    assert lvl.scratch * 4 == 16_785_408
    assert (lvl.sb_bind, lvl.sb_ets, lvl.sb_valid) == (0, 0, 4096)
    j1 = K.plan(K.MASK, 8, 8192, 65536, 3, 3, 2, 2, ALL, True)
    assert (j1.shape, j1.tb, j1.at, j1.nrt, j1.nt) == (4, 1024, 1024, 8, 64)
    assert j1.smem == 32 * 1024 + 20 * 1024 + 1024 + 12
    wide = K.plan(K.PAIRS, 1, 100, 3000, 16, 16, 16, 16, ALL, False, 7)
    assert wide.tb == 512 and wide.r == 1        # 71,680-byte tile
    assert wide.at == 256                        # 32 words a row: 32 KB
    paper = K.plan(K.PAIRS, 1, 100, 3000, 5, 2, 5, 1, ALL, False, 7)
    assert paper.at == 512                       # 10 words a row
    # the plan is built once per shape
    assert K.plan(K.PAIRS, 8, 65536, 4096, 2, 2, 1, 1, LEVEL_STACKED, True,
                  8192) is lvl


@pytest.mark.parametrize("args,match", [
    ((K.PAIRS, 1, 10, 10, 17, 2, 1, 1, ALL, False, 4), "maxima"),
    ((K.PAIRS, 1, 10, 10, 2, 2, 0, 1, ALL, False, 4), "maxima"),
    ((K.PAIRS, 0, 10, 10, 2, 2, 1, 1, ALL, False, 4), "n_slots"),
    ((K.MASK, 65536, 10, 10, 2, 2, 1, 1, ALL, False), "n_slots"),
    ((K.PAIRS, 1, 65536, 32769, 2, 2, 1, 1, ALL, False, 4), "overflow"),
    ((K.PAIRS, 1, 65536, 32768, 2, 2, 1, 1, ALL, False, 0), "overflow"),
    ((K.MASK, 1, 1, 65535 * 1024 + 1, 2, 2, 1, 1, ALL, False), "grid"),
    ((K.PAIRS, 1, 0, 10, 2, 2, 1, 1, ALL, False, 4), "rows"),
    ((K.PAIRS, 1, 10, 10, 2, 2, 1, 1, ALL, False, -1), "max_new"),
])
def test_launch_plan_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        K.plan(*args)


def test_pair_plan_takes_2_31_pairs_when_max_new_covers_the_excess():
    """A slot's pair total is read as unsigned: CA x CB may reach
    2^31 - 1 + max_new, so that n_dropped still fits an int32 (a
    capacity-sharded L0 join of 4 x 8192 gathered delta rows against a
    65536-row shard is exactly 2^31 pairs)."""
    p = K.plan(K.PAIRS, 4, 32768, 65536, 3, 3, 2, 2,
               (False,) * 3 + (True,) * 3, True, 8192)
    assert (p.sa_bind, p.sb_bind) == (0, 65536 * 3)
    K.plan(K.PAIRS, 1, 65536, 32768 + 1, 2, 2, 1, 1, ALL, False, 65537)
    from repro_torch.core.join import extract_pairs
    with pytest.raises(ValueError, match="overflow"):      # not allocated
        extract_pairs(torch.zeros((), dtype=torch.bool).expand(
            1, 65536, 32769), 65536)


@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_first_true_in_chunks_equals_one_scan(monkeypatch, chunk):
    """Rows past ``FIRST_TRUE_CHUNK`` (2^30: a slot's 2^31 pairs) are
    searched chunk by chunk; the answer is the one-scan answer."""
    from repro_torch.core import join as J

    gen = torch.Generator().manual_seed(chunk)
    cases = [(n, p, size) for n in (1, 7, 100, 257)
             for p in (0.0, 0.05, 0.5, 1.0) for size in (1, 5, 300)]
    want = [J.first_true(torch.rand((3, n), generator=gen) < p, size)
            for n, p, size in cases]
    gen.manual_seed(chunk)
    monkeypatch.setattr(J, "FIRST_TRUE_CHUNK", chunk)
    for (n, p, size), w in zip(cases, want):
        got = J.first_true(torch.rand((3, n), generator=gen) < p, size)
        assert torch.equal(got, w), (n, p, size)


def test_mask_plan_takes_more_than_2_31_pairs():
    """The mask writes with 64-bit offsets: only the pair counts are
    int32."""
    p = K.plan(K.MASK, 8, 65536, 65536, 3, 3, 2, 2, ALL, True)
    assert p.ca * p.cb >= 2**31 and p.scratch == 0


# --------------------------------------------------------------------- #
# What the plan shares with the source.
# --------------------------------------------------------------------- #
def test_plan_fields_follow_the_source_enum():
    """The plan goes to the CUDA source as an int64 array indexed by its
    P_* enum: the two orders must agree."""
    body = re.search(r"enum \{(\s*P_KIND.*?)\};", SRC, re.S).group(1)
    names = [x.strip() for x in body.split(",") if x.strip()]
    assert names[-1] == "P_COUNT"
    assert [x[2:].lower() for x in names[:-1]] == list(K.PLAN_FIELDS)
    kinds = re.search(r"enum \{ KIND_PAIRS = (\d), KIND_MASK = (\d) \};",
                      SRC)
    assert (int(kinds.group(1)), int(kinds.group(2))) == (K.PAIRS, K.MASK)


def test_shapes_follow_the_source_table():
    """The plan's instantiation index is a row of the source's CJ_SHAPES
    table, in its order."""
    body = re.search(r"#define CJ_SHAPES\(X\)(.*?)\n\n", SRC, re.S).group(1)
    rows = [tuple(int(v) for v in m.split(","))
            for m in re.findall(r"X\(([\d, ]+)\)", body)]
    assert tuple(rows) == K.SHAPES
    assert len(set(rows)) == len(rows)


def test_constants_follow_the_source():
    for name, value in (("CJ_MAX_NV", K.MAX_NV), ("CJ_MAX_NE", K.MAX_NE),
                        ("CJ_WIN", K.WIN), ("CJ_R", K.ROWS_PER_WARP),
                        ("CJ_SPEC_WORDS", K.SPEC_WORDS)):
        assert int(_define(name)) == value, name
    # the source checks the plan's shared memory against this limit
    assert "smem > 232448" in SRC and K.SMEM_LIMIT == 232_448
