// Compatibility join kernels for Hopper (sm_90a): the fused join with pair
// compaction (count / scan / emit), and the join predicate as a dense mask.
//
// Replaces the TPU kernels in src/repro/kernels/compat_join/kernel.py:
//   * compat_join_pairs_kernel          (body _pairs_body, predicate _tile_mask)
//   * compat_join_pairs_kernel_batched  (the same over a slot axis)
//   * compat_mask_kernel, compat_mask_kernel_batched  (body _mask_body)
// Each pair becomes one launch over a slot axis here: a single join is S = 1,
// and every operand carries a slot stride that is 0 when the operand is
// shared across the slots (a slot group's level joins share the stream-edge
// side), so a shared operand is read once per slot from cache instead of
// being broadcast S times through device memory.
//
// What it computes, per slot s: every pair (a, b) of rows of table A [CA]
// and table B [CB] that satisfies the join predicate
//   valid_a[a] && valid_b[b]
//   && for all vertex slot pairs (i, j): rel[i][j] ? bind_a[a,i] == bind_b[b,j]
//                                                  : bind_a[a,i] != bind_b[b,j]
//   && for all edge slot pairs (i, j): trel[i][j] == -1 -> ets_a[a,i] < ets_b[b,j]
//                                      trel[i][j] == +1 -> ets_a[a,i] > ets_b[b,j]
//   && (no window || max(all ts) - min(all ts) < window[s])   (int32, wrapping)
// The pair kernels write the first max_new pairs in row-major order of the
// mask as int64 (a_idx, b_idx) with a bool pair_valid (0 / false past the
// last pair), and n_dropped[s] = max(total - max_new, 0); the [CA, CB] mask
// is never written.  The mask kernel writes that mask as bytes.
//
// What bounds it on an H100.  Pairs: the predicate's int32 compare work,
// about (valid A rows) x (valid B rows) x (NVA*NVB + TREL columns + ~4
// window ops) per slot; the tables are narrow (a 65536 x 4096 level join
// reads under 2 MB), so the bytes are far below the compares.  Mask: the
// S x CA x CB bytes it writes (4.3e9 at the serving path's L0 shapes:
// 1.3 ms at 3.35 TB/s), with the compares of the valid pairs beside them.
//
// Design.
//   * Tiles.  B is cut into tiles of TB columns and A into tiles of AT rows;
//     a block owns one (A tile, B tile, slot).  It stages the B tile's VALID
//     rows in shared memory once, compacted in ascending column order by a
//     block-wide ballot prefix, as structure of arrays (bind[j][k], ets[j][k],
//     each row's timestamp min / max computed once, its column).  So no lane
//     waits on an invalid column, and B is read from device memory once per
//     block instead of once per A row.
//     The block's A rows are staged in shared memory too (the valid ones,
//     compacted, for the pair kernels), so a warp reads its next rows with
//     a shared-memory load instead of waiting on device memory.
//   * Registers.  A warp holds R A rows (warp-uniform) in registers, reduced
//     against the spec once per row (ARows): a B vertex column with a "must
//     equal" bit costs one compare against one A value, TREL two compares
//     per B timestamp column (inclusive bounds) instead of NEA, and the
//     window the row's timestamp span.  Its lanes walk the compacted columns
//     32 at a time, so one shared-memory read of a column serves R rows.
//   * The predicate is specialised per plan shape: Dims<NVA, NVB, NEA, NEB>
//     for each shape in CJ_SHAPES (the engine's chain level joins (k, 2,
//     k-1, 1) and the L0 joins of the serving tenants and the plan-check
//     corpus), so its loops unroll; one instantiation with runtime dims up to
//     CJ_MAX_NV / CJ_MAX_NE takes every other shape.  REL/TREL arrive as bit
//     masks in the by-value arguments (kernel parameters, uniform): REL as
//     "must equal" and "must differ" bits, TREL as "less" and "greater" bits.
//     The window is a template flag.
//   * Pairs: count / scan / emit.  The TPU kernel walks its grid in order and
//     carries an output cursor in SMEM; Hopper blocks run in no order, so:
//       1. cj_count: per (slot, A row, B tile) the number of matches (order
//          does not matter here: each lane counts its own columns, one
//          reduction per row), and per block their sum.  Invalid A rows are
//          skipped before they cost anything (their counts are 0).
//       2. cj_scan:  one block per (A tile, slot) adds the block sums of the
//          A tiles before it to get its base, scans its rows' counts in
//          (row, tile) row-major order into exclusive offsets, writes the
//          fill (0 / false) past min(total, max_new) and n_dropped.
//       3. cj_emit:  a block visits only the cells of its (A tile, B tile)
//          whose count is non-zero and whose offset is below max_new, and
//          returns before staging anything when there are none.  A cell
//          walks only its own tile's compacted columns, in order: lane k
//          writes its pair at offset + (matches before this chunk) +
//          popc(ballot & lanes below k), and the walk stops once the cell's
//          count is reached.
//     Pairs therefore come out in row-major order of the mask, exactly the
//     order of the plain version's nonzero, so kernel and plain version agree
//     element for element, overflow included.
//   * Mask: the same staged tile and predicate, over 512-column windows of
//     the tile.  Matches are rare, so a lane only ORs bit `pass` into a
//     per-row register when its column matches; one vote per row and window
//     finds the windows that hold any, and only those build their bits
//     (shared-memory atomicOr into the row's window frame) for the lanes
//     that store them.  Each lane stores 16 consecutive bytes with one
//     16-byte store (a warp stores 512 contiguous bytes); rows without a
//     valid A entry and columns without a match are zeros at store width.
//     A row start that is not 16-byte aligned shifts the window by its
//     misalignment; the partial chunks at either end of a window are
//     written byte by byte (a masked head / tail), so every byte is written
//     exactly once.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define CJ_MAX_NV 16
#define CJ_MAX_NE 16
#define CJ_THREADS 256               // count / emit / mask block (8 warps)
#define CJ_WARPS (CJ_THREADS / 32)
#define CJ_SCAN_THREADS 1024
#define CJ_SCAN_ITEMS 4              // counts per thread per scan pass
#define CJ_ITEMS 4                   // indices per thread per staging round
#define CJ_WIN 512                   // mask window: 32 lanes x 16 bytes
#define CJ_R 4                       // A rows per warp, specialised shapes
#define CJ_FULL 0xffffffffu

// The specialised plan shapes (NVA, NVB, NEA, NEB), in the order of
// kernel.py's SHAPES; index len(SHAPES) is the runtime-dims instantiation.
//   (2,2,1,1) (3,2,2,1) (4,2,3,1): a chain's level joins (k, 2, k-1, 1)
//   (5,2,5,1) (4,3,3,2): the paper's example query's L0 joins
//   (3,3,2,2): the serving two-chain tenants' L0 joins
#define CJ_SHAPES(X) \
  X(2, 2, 1, 1) X(3, 2, 2, 1) X(4, 2, 3, 1) X(5, 2, 5, 1) X(3, 3, 2, 2) \
  X(4, 3, 3, 2)

// The launch plan: an int64 array in this order (kernel.py's PLAN_FIELDS).
// P_SA_* / P_SB_*: the slot strides (elements; 0 = shared across slots) of
// bind, ets and valid of A and B.
enum {
  P_KIND, P_SLOTS, P_CA, P_CB, P_NVA, P_NVB, P_NEA, P_NEB, P_SA_BIND,
  P_SA_ETS, P_SA_VALID, P_SB_BIND, P_SB_ETS, P_SB_VALID, P_WINDOW,
  P_MAX_NEW, P_SHAPE, P_R, P_TB, P_AT, P_NT, P_NRT, P_SMEM, P_SCRATCH,
  P_COUNT
};
enum { KIND_PAIRS = 0, KIND_MASK = 1 };

// The encoded spec (kernel.py's encode_spec): 256-bit masks as 8 words.
struct CJSpec {
  uint32_t eq[8];    // bit i*nvb + j: rel[i][j]   (bind_a[i] == bind_b[j])
  uint32_t ne[8];    // bit i*nvb + j: !rel[i][j]  (bind_a[i] != bind_b[j])
  uint32_t lt[8];    // bit i*neb + j: trel[i][j] == -1 (ets_a[i] < ets_b[j])
  uint32_t gt[8];    // bit i*neb + j: trel[i][j] == +1 (ets_a[i] > ets_b[j])
  uint32_t lcol;     // bit j: column j of trel has an lt bit
  uint32_t gcol;     // bit j: column j of trel has a gt bit
  uint32_t qcol;     // bit j: column j of rel has an eq bit
};
#define CJ_SPEC_WORDS 35

struct CJArgs {
  const int32_t* bind_a;
  const int32_t* ets_a;
  const uint8_t* valid_a;
  const int32_t* bind_b;
  const int32_t* ets_b;
  const uint8_t* valid_b;
  const int32_t* window;           // [S], or null without a window
  long long sa_bind, sa_ets, sa_valid;   // slot strides (elements), 0 = shared
  long long sb_bind, sb_ets, sb_valid;
  int ca, cb, nva, nvb, nea, neb;
  int max_new, tb, at, nt, nrt;
  CJSpec spec;
};

// Plan shapes: compile-time dims (FIX) or the runtime ones, bounded by M*.
template <int VA, int VB, int EA, int EB, bool FIX = true>
struct Dims {
  static constexpr int MVA = VA, MVB = VB, MEA = EA, MEB = EB;
  __device__ static int nva(const CJArgs& p) { return FIX ? VA : p.nva; }
  __device__ static int nvb(const CJArgs& p) { return FIX ? VB : p.nvb; }
  __device__ static int nea(const CJArgs& p) { return FIX ? EA : p.nea; }
  __device__ static int neb(const CJArgs& p) { return FIX ? EB : p.neb; }
};
using AnyDims = Dims<CJ_MAX_NV, CJ_MAX_NV, CJ_MAX_NE, CJ_MAX_NE, false>;

__device__ __forceinline__ int32_t wrap_sub(int32_t x, int32_t y) {
  return (int32_t)((uint32_t)x - (uint32_t)y);
}

__device__ __forceinline__ bool bit(const uint32_t* m, int k) {
  return (m[k >> 5] >> (k & 31)) & 1u;
}

// 4 bits -> 4 bytes of 0 / 1 (the shifted copies never overlap).
__device__ __forceinline__ uint32_t expand4(uint32_t b) {
  return (b * 0x00204081u) & 0x01010101u;
}

// The R A rows a warp holds (the same values in every lane), reduced
// against the spec once per row so that a pair costs as few compares as
// the spec allows:
//   * a B vertex column j with an eq bit (qcol) must equal one A value v[j]:
//     the binding of the first i with an eq bit (i, j).  The row's other
//     bindings are checked against v[j] here, once: an eq bit needs
//     bind[i] == v[j], a ne bit bind[i] != v[j].  Then b_j == v[j] alone
//     decides the whole column for every pair of the row, and a row that
//     fails is not alive (it matches nothing);
//   * a column without an eq bit keeps one "must differ" compare per ne bit;
//   * TREL: per B timestamp column j, b_j must be above the largest ets_a[i]
//     with an lt bit and below the smallest with a gt bit, kept as the
//     inclusive bounds tlo[j] <= b_j <= thi[j] (INT32_MIN / INT32_MAX where
//     the column has no such bit; a bound that nothing meets makes the row
//     not alive), so that a pair pays two compares and no branch;
//   * the window: the row's timestamp span.
template <class D, int R>
struct ARows {
  int32_t bind[R][D::MVA];
  int32_t v[R][D::MVB];
  int32_t tlo[R][D::MEB];
  int32_t thi[R][D::MEB];
  int32_t mn[R], mx[R];
  bool alive[R];
};

// One staged B row (a lane's compacted column).
template <class D>
struct BCol {
  int32_t bind[D::MVB];
  int32_t ets[D::MEB];
  int32_t mn, mx;
};

// A single B timestamp makes its own span (the serving level joins).
template <class D>
__device__ __forceinline__ constexpr bool one_ets() {
  return D::MEB == 1;
}

// The compacted valid rows of one B tile in shared memory.
struct Tile {
  int32_t* bind;   // [nvb][tb]
  int32_t* ets;    // [neb][tb]
  int32_t* mn;     // [tb]
  int32_t* mx;     // [tb]
  int32_t* col;    // [tb]: the row's B index
  int cap;
};

__host__ __device__ inline long long tile_bytes(int nvb, int neb, int tb) {
  return 4LL * (nvb + neb + 3) * tb;
}

__device__ __forceinline__ Tile carve_tile(unsigned char* base,
                                           const CJArgs& p) {
  Tile t;
  int32_t* w = (int32_t*)base;
  t.cap = p.tb;
  t.bind = w;
  t.ets = w + (long long)p.nvb * p.tb;
  t.mn = t.ets + (long long)p.neb * p.tb;
  t.mx = t.mn + p.tb;
  t.col = t.mx + p.tb;
  return t;
}

// The block's A rows in shared memory, structure of arrays: value i of
// staged row k at v[i * at + k] (bindings, then timestamps).
struct ATile {
  int32_t* v;      // [nva + nea][at]
  int at;
};

__host__ __device__ inline long long atile_bytes(int nva, int nea, int at) {
  return 4LL * (nva + nea) * at;
}

// Copy row a of slot s into staged row k (one thread).
__device__ __forceinline__ void put_row(const CJArgs& p, int s, int a,
                                        const ATile& at, int k) {
  const int32_t* ba = p.bind_a + s * p.sa_bind + (long long)a * p.nva;
  const int32_t* ea = p.ets_a + s * p.sa_ets + (long long)a * p.nea;
  for (int i = 0; i < p.nva; ++i) at.v[i * at.at + k] = ba[i];
  for (int i = 0; i < p.nea; ++i) at.v[(p.nva + i) * at.at + k] = ea[i];
}

// Staged row k into the warp's row r.
template <class D, int R, bool WIN>
__device__ __forceinline__ void load_row(const CJArgs& p, const ATile& at,
                                         int k, int r, ARows<D, R>& A) {
  const int nva = D::nva(p), nvb = D::nvb(p), nea = D::nea(p),
            neb = D::neb(p);
  int32_t e[D::MEA];
#pragma unroll
  for (int i = 0; i < D::MVA; ++i)
    if (i < nva) A.bind[r][i] = at.v[i * at.at + k];
#pragma unroll
  for (int i = 0; i < D::MEA; ++i)
    if (i < nea) e[i] = at.v[(nva + i) * at.at + k];
  bool alive = true;
#pragma unroll
  for (int j = 0; j < D::MVB; ++j) {
    if (j >= nvb || !((p.spec.qcol >> j) & 1u)) continue;
    int32_t v = 0;
    bool found = false;
#pragma unroll
    for (int i = 0; i < D::MVA; ++i)
      if (i < nva && !found && bit(p.spec.eq, i * nvb + j)) {
        v = A.bind[r][i];
        found = true;
      }
#pragma unroll
    for (int i = 0; i < D::MVA; ++i) {
      if (i >= nva) continue;
      if (bit(p.spec.eq, i * nvb + j)) alive &= A.bind[r][i] == v;
      if (bit(p.spec.ne, i * nvb + j)) alive &= A.bind[r][i] != v;
    }
    A.v[r][j] = v;
  }
#pragma unroll
  for (int j = 0; j < D::MEB; ++j) {
    if (j >= neb) continue;
    int32_t lo = INT32_MIN, hi = INT32_MAX;
    bool has_lo = false, has_hi = false;
#pragma unroll
    for (int i = 0; i < D::MEA; ++i) {
      if (i >= nea) continue;
      if (bit(p.spec.lt, i * neb + j)) { lo = max(lo, e[i]); has_lo = true; }
      if (bit(p.spec.gt, i * neb + j)) { hi = min(hi, e[i]); has_hi = true; }
    }
    // b > lo  <=>  b >= lo + 1, and b < hi  <=>  b <= hi - 1
    alive &= !(has_lo && lo == INT32_MAX) && !(has_hi && hi == INT32_MIN);
    A.tlo[r][j] = has_lo ? wrap_sub(lo, -1) : INT32_MIN;
    A.thi[r][j] = has_hi ? wrap_sub(hi, 1) : INT32_MAX;
    // computed once a row: keep the compiler from recomputing them in the
    // column loop, where their only uses are
    asm volatile("" : "+r"(A.tlo[r][j]), "+r"(A.thi[r][j]));
  }
  A.alive[r] = alive;
  if (WIN) {
    int32_t mn = e[0], mx = e[0];
#pragma unroll
    for (int i = 1; i < D::MEA; ++i)
      if (i < nea) { mn = min(mn, e[i]); mx = max(mx, e[i]); }
    A.mn[r] = mn;
    A.mx[r] = mx;
  }
}

template <class D, bool WIN>
__device__ __forceinline__ void load_col(const CJArgs& p, const Tile& t,
                                         int k, BCol<D>& B) {
#pragma unroll
  for (int j = 0; j < D::MVB; ++j)
    if (j < D::nvb(p)) B.bind[j] = t.bind[j * t.cap + k];
#pragma unroll
  for (int j = 0; j < D::MEB; ++j)
    if (j < D::neb(p)) B.ets[j] = t.ets[j * t.cap + k];
  if (WIN) {
    if (one_ets<D>()) {
      B.mn = B.ets[0];
      B.mx = B.ets[0];
    } else {
      B.mn = t.mn[k];
      B.mx = t.mx[k];
    }
  }
}

// The join predicate of the warp's R rows against one staged B row,
// ANDed into ok[] (which the caller starts from the rows' and the column's
// validity).  The branches on the spec are uniform and amortised over the
// R rows.
template <class D, int R, bool WIN>
__device__ __forceinline__ void pred_rows(const CJArgs& p,
                                          const ARows<D, R>& A,
                                          const BCol<D>& B, int32_t w,
                                          bool (&ok)[R]) {
  const int nva = D::nva(p), nvb = D::nvb(p), neb = D::neb(p);
#pragma unroll
  for (int j = 0; j < D::MVB; ++j) {
    if (j >= nvb) continue;
    if ((p.spec.qcol >> j) & 1u) {
#pragma unroll
      for (int r = 0; r < R; ++r) ok[r] &= B.bind[j] == A.v[r][j];
    } else {
#pragma unroll
      for (int i = 0; i < D::MVA; ++i) {
        if (i >= nva || !bit(p.spec.ne, i * nvb + j)) continue;
#pragma unroll
        for (int r = 0; r < R; ++r) ok[r] &= B.bind[j] != A.bind[r][i];
      }
    }
  }
  if (p.spec.lcol | p.spec.gcol) {
#pragma unroll
    for (int j = 0; j < D::MEB; ++j) {
      if (j >= neb) continue;
#pragma unroll
      for (int r = 0; r < R; ++r)
        ok[r] &= B.ets[j] >= A.tlo[r][j] && B.ets[j] <= A.thi[r][j];
    }
  }
  if (WIN) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      ok[r] &= wrap_sub(max(A.mx[r], B.mx), min(A.mn[r], B.mn)) < w;
  }
}

__device__ __forceinline__ int32_t warp_incl(int32_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t u = __shfl_up_sync(CJ_FULL, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__device__ __forceinline__ int32_t warp_sum(int32_t v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(CJ_FULL, v, d);
  return v;
}

// Block-wide exclusive scan of one int per thread: returns this thread's
// prefix and the block's total in *total.  red: CJ_WARPS ints.
__device__ __forceinline__ int block_excl(int v, int* total, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_incl(v, lane);
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int before = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < CJ_WARPS; ++w) {
    const int x = red[w];
    tot += x;
    if (w < warp) before += x;
  }
  __syncthreads();                                      // red is free again
  *total = tot;
  return before + incl - v;
}

// Block-wide compaction of the indices in [lo, hi) for which keep(i) holds,
// in ascending order, into list[]; put(i, k) is called for the k-th kept
// index, skip(i) for the others.  Each thread takes CJ_ITEMS consecutive
// indices a round, so their loads go out together.  Returns the number
// kept (the same in every thread), with list[] and put's writes visible.
template <class Keep, class Put, class Skip>
__device__ int compact(int lo, int hi, Keep keep, Put put, Skip skip,
                       int* list, int* red) {
  int base = 0;
  for (int c0 = lo; c0 < hi; c0 += CJ_THREADS * CJ_ITEMS) {
    const int i0 = c0 + (int)threadIdx.x * CJ_ITEMS;
    bool v[CJ_ITEMS];
    int n = 0;
#pragma unroll
    for (int q = 0; q < CJ_ITEMS; ++q) {
      v[q] = keep(min(i0 + q, hi - 1)) && i0 + q < hi;
      n += v[q];
    }
    int total;
    int k = base + block_excl(n, &total, red);
#pragma unroll
    for (int q = 0; q < CJ_ITEMS; ++q) {
      if (i0 + q >= hi) continue;
      if (v[q]) {
        list[k] = i0 + q;
        put(i0 + q, k++);
      } else {
        skip(i0 + q);
      }
    }
    base += total;
  }
  __syncthreads();
  return base;
}

// Stage the valid rows of B columns [b_lo, b_hi) of slot s into t, compacted
// in ascending order (CJ_ITEMS consecutive columns a thread).  With wk (the
// mask), wk[w] is the compacted index of the first valid column at or after
// b_lo + w * CJ_WIN, for every window w, and wk[n_windows] the count.
// Returns the count (the same in every thread), with t and wk visible.
template <class D, bool WIN>
__device__ int stage_b(const CJArgs& p, int s, int b_lo, int b_hi,
                       const Tile& t, int* wk, int* red) {
  const int nvb = D::nvb(p), neb = D::neb(p);
  const uint8_t* vb = p.valid_b + s * p.sb_valid;
  const int32_t* bb = p.bind_b + s * p.sb_bind;
  const int32_t* eb = p.ets_b + s * p.sb_ets;
  int base = 0;
  for (int c0 = b_lo; c0 < b_hi; c0 += CJ_THREADS * CJ_ITEMS) {
    const int i0 = c0 + (int)threadIdx.x * CJ_ITEMS;
    bool v[CJ_ITEMS];
    int n = 0;
#pragma unroll
    for (int q = 0; q < CJ_ITEMS; ++q) {
      v[q] = vb[min(i0 + q, b_hi - 1)] != 0 && i0 + q < b_hi;
      n += v[q];
    }
    int total;
    int k = base + block_excl(n, &total, red);
    if (wk != nullptr && i0 < b_hi && (i0 - b_lo) % CJ_WIN == 0)
      wk[(i0 - b_lo) / CJ_WIN] = k;
#pragma unroll
    for (int q = 0; q < CJ_ITEMS; ++q) {
      if (!v[q]) continue;
      const int c = i0 + q;
      const int32_t* brow = bb + (long long)c * nvb;
      const int32_t* erow = eb + (long long)c * neb;
#pragma unroll
      for (int j = 0; j < D::MVB; ++j)
        if (j < nvb) t.bind[j * t.cap + k] = brow[j];
      int32_t mn = erow[0], mx = erow[0];
#pragma unroll
      for (int j = 0; j < D::MEB; ++j) {
        if (j >= neb) continue;
        const int32_t x = erow[j];
        t.ets[j * t.cap + k] = x;
        mn = min(mn, x);
        mx = max(mx, x);
      }
      if (WIN) {
        t.mn[k] = mn;
        t.mx[k] = mx;
      }
      t.col[k] = c;
      ++k;
    }
    base += total;
  }
  if (wk != nullptr && threadIdx.x == 0)
    wk[(b_hi - b_lo + CJ_WIN - 1) / CJ_WIN] = base;
  __syncthreads();
  return base;
}

// ---------------------------------------------------------------------------
// 1. count: counts[(s*CA + a)*NT + bt] and blocksum[(s*NRT + rt)*NT + bt].
// ---------------------------------------------------------------------------
template <class D, int R, bool WIN>
__global__ void __launch_bounds__(CJ_THREADS)
cj_count(const __grid_constant__ CJArgs p, int32_t* __restrict__ counts,
         int32_t* __restrict__ blocksum) {
  extern __shared__ __align__(16) unsigned char cj_smem[];
  __shared__ int red[CJ_WARPS];
  const int rt = blockIdx.x, bt = blockIdx.y, s = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int a_lo = rt * p.at, b_lo = bt * p.tb;
  const int a_hi = (int)min((long long)a_lo + p.at, (long long)p.ca);
  const int b_hi = (int)min((long long)b_lo + p.tb, (long long)p.cb);
  int* rows = (int*)cj_smem;                              // [at]
  const ATile at{(int32_t*)(cj_smem + 4LL * p.at), p.at};
  const Tile t = carve_tile(
      cj_smem + 4LL * p.at + atile_bytes(p.nva, p.nea, p.at), p);
  const uint8_t* va = p.valid_a + s * p.sa_valid;
  int32_t* cnt = counts + (long long)s * p.ca * p.nt + bt;
  const long long nt = p.nt;
  const int na = compact(
      a_lo, a_hi, [&](int a) { return va[a] != 0; },
      [&](int a, int k) { put_row(p, s, a, at, k); },
      [&](int a) { cnt[a * nt] = 0; }, rows, red);
  int mine = 0;
  if (na > 0) {
    const int nk = stage_b<D, WIN>(p, s, b_lo, b_hi, t, nullptr, red);
    const int32_t w = WIN ? p.window[s] : 0;
    for (int r0 = warp * R; r0 < na; r0 += CJ_WARPS * R) {
      ARows<D, R> A;
      int arow[R], c[R];
      bool go[R], any = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        arow[r] = rows[min(r0 + r, na - 1)];
        load_row<D, R, WIN>(p, at, min(r0 + r, na - 1), r, A);
        go[r] = r0 + r < na && A.alive[r];
        any |= go[r];
        c[r] = 0;
      }
      // each lane counts its own columns; one reduction per row at the end
      for (int k0 = 0; any && k0 < nk; k0 += 32) {
        const int k = k0 + lane;
        BCol<D> B;
        load_col<D, WIN>(p, t, min(k, nk - 1), B);
        bool ok[R];
#pragma unroll
        for (int r = 0; r < R; ++r) ok[r] = go[r] && k < nk;
        pred_rows<D, R, WIN>(p, A, B, w, ok);
#pragma unroll
        for (int r = 0; r < R; ++r) c[r] += ok[r];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) c[r] = warp_sum(c[r]);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r0 + r < na) {
            cnt[arow[r] * nt] = c[r];
            mine += c[r];
          }
      }
    }
  }
  __syncthreads();                  // red is free again
  if (lane == 0) red[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tot = 0;
#pragma unroll
    for (int w = 0; w < CJ_WARPS; ++w) tot += red[w];
    blocksum[((long long)s * p.nrt + rt) * p.nt + bt] = tot;
  }
}

// ---------------------------------------------------------------------------
// 2. scan: one block per (A tile rt, slot s).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(CJ_SCAN_THREADS)
cj_scan(const int32_t* __restrict__ counts, int32_t* __restrict__ offsets,
        const int32_t* __restrict__ blocksum, int64_t* __restrict__ a_out,
        int64_t* __restrict__ b_out, uint8_t* __restrict__ v_out,
        int32_t* __restrict__ n_dropped, int ca, int at, int nt, int nrt,
        int max_new) {
  __shared__ int32_t ws[32];
  __shared__ int32_t ws2[32];
  const int rt = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // the block sums of the A tiles before this one, and of all of them
  const int32_t* bs = blocksum + (long long)s * nrt * nt;
  const long long nbs = (long long)nrt * nt, lim = (long long)rt * nt;
  int32_t base = 0, tot = 0;
  for (long long i = tid; i < nbs; i += CJ_SCAN_THREADS) {
    const int32_t v = bs[i];
    tot += v;
    if (i < lim) base += v;
  }
  base = warp_sum(base);
  tot = warp_sum(tot);
  if (lane == 0) { ws[warp] = base; ws2[warp] = tot; }
  __syncthreads();
  base = 0;
  tot = 0;
#pragma unroll 4
  for (int w = 0; w < 32; ++w) { base += ws[w]; tot += ws2[w]; }
  __syncthreads();
  // this tile's counts, row-major over (row, B tile), into exclusive offsets
  const long long r0 = (long long)rt * at;
  const long long n = (long long)min(at, ca - rt * at) * nt;
  const int32_t* c = counts + ((long long)s * ca + r0) * nt;
  int32_t* o = offsets + ((long long)s * ca + r0) * nt;
  int32_t run = base;
  for (long long c0 = 0; c0 < n;
       c0 += (long long)CJ_SCAN_THREADS * CJ_SCAN_ITEMS) {
    const long long i0 = c0 + (long long)tid * CJ_SCAN_ITEMS;
    int32_t v[CJ_SCAN_ITEMS], sum = 0;
#pragma unroll
    for (int i = 0; i < CJ_SCAN_ITEMS; ++i) {
      v[i] = i0 + i < n ? c[i0 + i] : 0;
      sum += v[i];
    }
    const int32_t incl = warp_incl(sum, lane);
    if (lane == 31) ws[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int32_t x = ws[lane];
      const int32_t xi = warp_incl(x, lane);
      ws2[lane] = xi - x;
      if (lane == 31) ws[0] = xi;            // read by all after the sync
    }
    __syncthreads();
    int32_t pre = run + ws2[warp] + incl - sum;
#pragma unroll
    for (int i = 0; i < CJ_SCAN_ITEMS; ++i) {
      if (i0 + i < n) o[i0 + i] = pre;
      pre += v[i];
    }
    run += ws[0];
    __syncthreads();
  }
  // the fill past min(total, max_new), cut into one share per A tile.  The
  // total and the offsets are read as unsigned: a slot's pair total reaches
  // CA * CB, which the plan bounds by 2^31 - 1 + max_new (so that n_dropped
  // fits an int32), and the int32 sums above are exact modulo 2^32
  const uint32_t utot = (uint32_t)tot;
  const long long kept = min((long long)utot, (long long)max_new);
  const long long per = ((long long)max_new + nrt - 1) / nrt;
  const long long lo = max((long long)rt * per, kept);
  const long long hi = min((long long)(rt + 1) * per, (long long)max_new);
  int64_t* ao = a_out + (long long)s * max_new;
  int64_t* bo = b_out + (long long)s * max_new;
  uint8_t* vo = v_out + (long long)s * max_new;
  for (long long i = lo + tid; i < hi; i += CJ_SCAN_THREADS) {
    ao[i] = 0;
    bo[i] = 0;
    vo[i] = 0;
  }
  if (rt == 0 && tid == 0)
    n_dropped[s] = utot > (uint32_t)max_new
                       ? (int32_t)(utot - (uint32_t)max_new) : 0;
}

// ---------------------------------------------------------------------------
// 3. emit: the non-empty cells of (A tile rt, B tile bt, slot s) below
//    max_new.
// ---------------------------------------------------------------------------
template <class D, int R, bool WIN>
__global__ void __launch_bounds__(CJ_THREADS)
cj_emit(const __grid_constant__ CJArgs p, const int32_t* __restrict__ counts,
        const int32_t* __restrict__ offsets, int64_t* __restrict__ a_out,
        int64_t* __restrict__ b_out, uint8_t* __restrict__ v_out) {
  extern __shared__ __align__(16) unsigned char cj_smem[];
  __shared__ int red[CJ_WARPS];
  const int rt = blockIdx.x, bt = blockIdx.y, s = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int a_lo = rt * p.at, b_lo = bt * p.tb;
  const int a_hi = (int)min((long long)a_lo + p.at, (long long)p.ca);
  const int b_hi = (int)min((long long)b_lo + p.tb, (long long)p.cb);
  int* rows = (int*)cj_smem;                              // [at]
  const ATile at{(int32_t*)(cj_smem + 4LL * p.at), p.at};
  const Tile t = carve_tile(
      cj_smem + 4LL * p.at + atile_bytes(p.nva, p.nea, p.at), p);
  const long long cell0 = (long long)s * p.ca * p.nt + bt, nt = p.nt;
  const int max_new = p.max_new;
  const int na = compact(
      a_lo, a_hi,
      [&](int a) {
        const long long i = cell0 + a * nt;
        return counts[i] > 0 && (uint32_t)offsets[i] < (uint32_t)max_new;
      },
      [&](int a, int k) { put_row(p, s, a, at, k); }, [](int) {}, rows,
      red);
  if (na == 0) return;                          // block-uniform
  const int nk = stage_b<D, WIN>(p, s, b_lo, b_hi, t, nullptr, red);
  const int32_t w = WIN ? p.window[s] : 0;
  int64_t* ao = a_out + (long long)s * max_new;
  int64_t* bo = b_out + (long long)s * max_new;
  uint8_t* vo = v_out + (long long)s * max_new;
  const unsigned below = (1u << lane) - 1u;
  for (int r0 = warp * R; r0 < na; r0 += CJ_WARPS * R) {
    ARows<D, R> A;
    int arow[R], run[R], end[R];
    bool more = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      arow[r] = rows[min(r0 + r, na - 1)];
      load_row<D, R, WIN>(p, at, min(r0 + r, na - 1), r, A);
      const long long i = cell0 + arow[r] * nt;
      run[r] = offsets[i];
      end[r] = r0 + r < na ? min(run[r] + counts[i], max_new) : run[r];
      more |= run[r] < end[r];
    }
    for (int k0 = 0; k0 < nk && more; k0 += 32) {
      const int k = k0 + lane;
      BCol<D> B;
      load_col<D, WIN>(p, t, min(k, nk - 1), B);
      const int b = t.col[min(k, nk - 1)];
      bool ok[R];
#pragma unroll
      for (int r = 0; r < R; ++r) ok[r] = run[r] < end[r] && k < nk;
      pred_rows<D, R, WIN>(p, A, B, w, ok);
      more = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const unsigned m = __ballot_sync(CJ_FULL, ok[r]);
        if (ok[r]) {
          const int pos = run[r] + __popc(m & below);
          if (pos < end[r]) {
            ao[pos] = arow[r];
            bo[pos] = b;
            vo[pos] = 1;
          }
        }
        run[r] += __popc(m);
        more |= run[r] < end[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The mask: out[s, a, b] for A rows [rt*AT, ...) x B tile bt of slot s.
// ---------------------------------------------------------------------------

// Store one window of one mask row.  Chunk ch (0..32) of the window is the
// 16 bytes at row + wlo - dl + 16*ch, which is 16-byte aligned (row lies dl
// past a 16-byte boundary, wlo is a multiple of CJ_WIN); its byte i is
// column wlo - dl + 16*ch + i.  The window's columns [wlo, whi) are bytes
// [dl, dl + whi - wlo) of the frame.  Lane L holds chunk L's 16 bits in
// bits (lane 0 also chunk 32's in extra) and stores them: whole chunks with
// one 16-byte store, the partial ones at the window's ends byte by byte.
__device__ __forceinline__ void store_window(uint8_t* row, int wlo, int whi,
                                             int dl, uint32_t bits,
                                             uint32_t extra, int lane) {
  const int vlo = dl, vhi = dl + (whi - wlo);
  uint8_t* dst0 = row + wlo - dl;
  for (int ch = lane; ch <= CJ_WIN / 16; ch += 32) {
    const uint32_t b = ch < 32 ? bits : extra;
    const int b0 = 16 * ch;
    if (b0 >= vhi || b0 + 16 <= vlo) continue;
    if (b0 >= vlo && b0 + 16 <= vhi) {
      *(uint4*)(dst0 + b0) = make_uint4(expand4(b & 15u),
                                        expand4((b >> 4) & 15u),
                                        expand4((b >> 8) & 15u),
                                        expand4((b >> 12) & 15u));
    } else {
      const int i1 = min(b0 + 16, vhi);
      for (int i = max(b0, vlo); i < i1; ++i)
        dst0[i] = (uint8_t)((b >> (i - b0)) & 1u);
    }
  }
}

template <class D, int R, bool WIN>
__global__ void __launch_bounds__(CJ_THREADS)
cj_mask(const __grid_constant__ CJArgs p, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char cj_smem[];
  __shared__ int red[CJ_WARPS];
  // a row's window as bits (bit i = frame byte i), for the rare windows
  // that hold a match: 17 words cover the 528-byte frame
  __shared__ uint32_t frame[CJ_WARPS][R][CJ_WIN / 32 + 1];
  const int rt = blockIdx.x, bt = blockIdx.y, s = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int a_lo = rt * p.at, b_lo = bt * p.tb;
  const int a_hi = (int)min((long long)a_lo + p.at, (long long)p.ca);
  const int b_hi = (int)min((long long)b_lo + p.tb, (long long)p.cb);
  const int n_win = (b_hi - b_lo + CJ_WIN - 1) / CJ_WIN;
  const Tile t = carve_tile(cj_smem, p);
  const long long tb_bytes = tile_bytes(p.nvb, p.neb, p.tb);
  const ATile at{(int32_t*)(cj_smem + tb_bytes), p.at};
  uint8_t* a_ok = cj_smem + tb_bytes + atile_bytes(p.nva, p.nea, p.at);
  int* wk = (int*)(a_ok + p.at);
  const uint8_t* va = p.valid_a + s * p.sa_valid;
#pragma unroll 4
  for (int a = a_lo + (int)threadIdx.x; a < a_hi; a += CJ_THREADS) {
    put_row(p, s, a, at, a - a_lo);
    a_ok[a - a_lo] = va[a];
  }
  stage_b<D, WIN>(p, s, b_lo, b_hi, t, wk, red);     // syncs the block
  const int32_t w = WIN ? p.window[s] : 0;
  for (int r0 = a_lo + warp * R; r0 < a_hi; r0 += CJ_WARPS * R) {
    ARows<D, R> A;
    bool go[R], any = false;
    uint8_t* row[R];
    int dl[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = min(r0 + r, a_hi - 1);
      load_row<D, R, WIN>(p, at, a - a_lo, r, A);
      go[r] = r0 + r < a_hi && a_ok[a - a_lo] != 0 && A.alive[r];
      any |= go[r];
      row[r] = out + ((long long)s * p.ca + a) * (long long)p.cb;
      dl[r] = (int)((uintptr_t)row[r] & 15);
    }
    for (int wi = 0; wi < n_win; ++wi) {
      const int wlo = b_lo + wi * CJ_WIN, whi = min(wlo + CJ_WIN, b_hi);
      const int k_lo = wk[wi], k_hi = wk[wi + 1];
      // bit it of hit[r]: this lane's column of pass it matches row r (a
      // window holds at most CJ_WIN / 32 = 16 passes of 32 columns)
      uint32_t hit[R];
#pragma unroll
      for (int r = 0; r < R; ++r) hit[r] = 0u;
      int it = 0;
      for (int k0 = k_lo; any && k0 < k_hi; k0 += 32, ++it) {
        BCol<D> B;
        load_col<D, WIN>(p, t, min(k0 + lane, k_hi - 1), B);
        bool ok[R];
#pragma unroll
        for (int r = 0; r < R; ++r) ok[r] = go[r] && k0 + lane < k_hi;
        pred_rows<D, R, WIN>(p, A, B, w, ok);
#pragma unroll
        for (int r = 0; r < R; ++r) hit[r] |= (uint32_t)ok[r] << it;
      }
      uint32_t bits[R], extra[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        bits[r] = extra[r] = 0u;
        if (!__any_sync(CJ_FULL, hit[r] != 0u)) continue;   // the usual case
        // the lane of each match sets its frame bit; the lane that stores
        // the match's 16-byte chunk reads it back
        uint32_t* f = frame[warp][r];
        if (lane <= CJ_WIN / 32) f[lane] = 0u;
        __syncwarp();
        for (uint32_t h = hit[r]; h != 0u; h &= h - 1u) {
          const int k = k_lo + 32 * (__ffs(h) - 1) + lane;
          const int pos = t.col[k] - wlo + dl[r];
          atomicOr(&f[pos >> 5], 1u << (pos & 31));
        }
        __syncwarp();
        bits[r] = (f[lane >> 1] >> (16 * (lane & 1))) & 0xffffu;
        extra[r] = f[CJ_WIN / 32] & 0xffffu;
        __syncwarp();
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r0 + r >= a_hi) continue;
        if (dl[r] == 0 && whi - wlo == CJ_WIN) {        // aligned, whole
          const uint32_t b = bits[r];
          *(uint4*)(row[r] + wlo + 16 * lane) = make_uint4(
              expand4(b & 15u), expand4((b >> 4) & 15u),
              expand4((b >> 8) & 15u), expand4((b >> 12) & 15u));
        } else {
          store_window(row[r], wlo, whi, dl[r], bits[r], extra[r], lane);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: the instantiation table, shared-memory sizes, launches.
// ---------------------------------------------------------------------------
typedef void (*PairKernel)(CJArgs, int32_t*, int32_t*);
typedef void (*EmitKernel)(CJArgs, const int32_t*, const int32_t*, int64_t*,
                           int64_t*, uint8_t*);
typedef void (*MaskKernel)(CJArgs, uint8_t*);

struct CJKernels {
  PairKernel count;
  EmitKernel emit;
  MaskKernel mask;
  int r;
};

template <class D, int R, bool WIN>
static CJKernels kernels_of() {
  CJKernels k;
  k.count = cj_count<D, R, WIN>;
  k.emit = cj_emit<D, R, WIN>;
  k.mask = cj_mask<D, R, WIN>;
  k.r = R;
  return k;
}

#define CJ_ROW(VA, VB, EA, EB)                                  \
  {kernels_of<Dims<VA, VB, EA, EB>, CJ_R, false>(),             \
   kernels_of<Dims<VA, VB, EA, EB>, CJ_R, true>()},
static const CJKernels CJ_TABLE[][2] = {
    CJ_SHAPES(CJ_ROW)
    {kernels_of<AnyDims, 1, false>(), kernels_of<AnyDims, 1, true>()}};
#undef CJ_ROW
static const int CJ_N_SHAPES =
    (int)(sizeof(CJ_TABLE) / sizeof(CJ_TABLE[0])) - 1;
#define CJ_SHAPE_DIMS(VA, VB, EA, EB) {VA, VB, EA, EB},
static const int CJ_DIMS[][4] = {CJ_SHAPES(CJ_SHAPE_DIMS)};
#undef CJ_SHAPE_DIMS

// Dynamic shared memory of a block (kernel.py's smem_bytes).  Pairs: the
// compacted A row list, the staged A rows, the staged B tile.  Mask: the
// staged B tile, the block's A rows and their validity, the window bounds.
static long long smem_bytes(int kind, int nva, int nvb, int nea, int neb,
                            int tb, int at) {
  const long long tile = tile_bytes(nvb, neb, tb);
  const long long rows = atile_bytes(nva, nea, at);
  if (kind == KIND_PAIRS) return 4LL * at + rows + tile;
  return tile + rows + at + 4LL * (tb / CJ_WIN + 1);
}

// Opt a kernel into `bytes` of dynamic shared memory.  The 48 KB a kernel
// gets without asking covers its static shared memory too, so the opt-in is
// made for any dynamic size, once per kernel and size (launches hold the
// Python interpreter lock, so the cache needs no lock of its own).
static int set_smem(const void* fn, long long bytes) {
  static const void* fns[64];
  static long long granted[64];
  static int n = 0;
  int i = 0;
  while (i < n && fns[i] != fn) ++i;
  if (i < n && granted[i] >= bytes) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (i == n && n < 64) fns[n++] = fn;
  if (i < n) granted[i] = bytes;
  return 0;
}

// Check the plan against the operands and fill the by-value arguments.
// Returns 0 or cudaErrorInvalidValue.
static int make_args(CJArgs* p, const long long* P, int n_fields, int kind,
                     const void* bind_a, const void* ets_a,
                     const void* valid_a, const void* bind_b,
                     const void* ets_b, const void* valid_b,
                     const void* window, const uint32_t* spec) {
  const int bad = (int)cudaErrorInvalidValue;
  if (n_fields != P_COUNT || P[P_KIND] != kind) return bad;
  const long long S = P[P_SLOTS], ca = P[P_CA], cb = P[P_CB];
  const long long nva = P[P_NVA], nvb = P[P_NVB], nea = P[P_NEA],
                  neb = P[P_NEB];
  const long long shape = P[P_SHAPE], tb = P[P_TB], at = P[P_AT];
  if (nva < 1 || nvb < 1 || nea < 1 || neb < 1 || nva > CJ_MAX_NV ||
      nvb > CJ_MAX_NV || nea > CJ_MAX_NE || neb > CJ_MAX_NE)
    return bad;
  if (S < 1 || S > 65535 || ca < 1 || cb < 1 || ca >= (1LL << 31) ||
      cb >= (1LL << 31) || P[P_MAX_NEW] < 0 || P[P_MAX_NEW] >= (1LL << 31))
    return bad;
  if (tb < CJ_WIN || tb % CJ_WIN || at < 16 || at % 16)
    return bad;
  // the emit's cursor (below max_new) plus a cell's matches (at most tb)
  // stays an int
  if (P[P_MAX_NEW] > (1LL << 31) - tb) return bad;
  if (P[P_NT] != (cb + tb - 1) / tb || P[P_NRT] != (ca + at - 1) / at ||
      P[P_NT] > 65535 || P[P_NRT] >= (1LL << 31))
    return bad;
  if (shape < 0 || shape > CJ_N_SHAPES) return bad;
  if (shape < CJ_N_SHAPES &&
      (CJ_DIMS[shape][0] != nva || CJ_DIMS[shape][1] != nvb ||
       CJ_DIMS[shape][2] != nea || CJ_DIMS[shape][3] != neb))
    return bad;
  if (P[P_R] != CJ_TABLE[shape][0].r) return bad;
  const long long smem = smem_bytes(kind, (int)nva, (int)nvb, (int)nea,
                                    (int)neb, (int)tb, (int)at);
  if (P[P_SMEM] != smem || smem > 232448) return bad;
  if (kind == KIND_PAIRS) {
    // a slot's pair total may reach CA * CB; n_dropped must fit an int32
    if (ca * cb - P[P_MAX_NEW] >= (1LL << 31)) return bad;
    if (P[P_SCRATCH] != 2 * S * ca * P[P_NT] + S * P[P_NRT] * P[P_NT])
      return bad;
  }
  if ((P[P_WINDOW] != 0) != (window != nullptr)) return bad;
  memset(p, 0, sizeof(*p));
  p->bind_a = (const int32_t*)bind_a;
  p->ets_a = (const int32_t*)ets_a;
  p->valid_a = (const uint8_t*)valid_a;
  p->bind_b = (const int32_t*)bind_b;
  p->ets_b = (const int32_t*)ets_b;
  p->valid_b = (const uint8_t*)valid_b;
  p->window = (const int32_t*)window;
  p->sa_bind = P[P_SA_BIND]; p->sa_ets = P[P_SA_ETS];
  p->sa_valid = P[P_SA_VALID];
  p->sb_bind = P[P_SB_BIND]; p->sb_ets = P[P_SB_ETS];
  p->sb_valid = P[P_SB_VALID];
  p->ca = (int)ca; p->cb = (int)cb;
  p->nva = (int)nva; p->nvb = (int)nvb; p->nea = (int)nea; p->neb = (int)neb;
  p->max_new = (int)P[P_MAX_NEW];
  p->tb = (int)tb; p->at = (int)at;
  p->nt = (int)P[P_NT]; p->nrt = (int)P[P_NRT];
  static_assert(sizeof(CJSpec) == CJ_SPEC_WORDS * 4, "spec layout");
  memcpy(&p->spec, spec, sizeof(CJSpec));
  return 0;
}

// Plain C entry points, bound with ctypes.  plan: P_COUNT int64 values
// (kernel.py's plan()); spec: CJ_SPEC_WORDS uint32 (kernel.py's
// encode_spec).  plan and spec are HOST memory; every other pointer is
// device memory.  Each returns cudaGetLastError() after its launches (0 =
// ok), or cudaErrorInvalidValue for a plan that does not fit the operands.
//
// compat_join_pairs_launch: a_out / b_out int64 [S, max_new], v_out bool
// [S, max_new], n_dropped int32 [S], all written; scratch int32 [P_SCRATCH]
// (counts, offsets, block sums).
extern "C" int compat_join_pairs_launch(
    const void* bind_a, const void* ets_a, const void* valid_a,
    const void* bind_b, const void* ets_b, const void* valid_b,
    const void* window, const long long* plan, int n_fields,
    const uint32_t* spec, void* a_out, void* b_out,
    void* v_out, void* n_dropped, void* scratch, void* stream) {
  CJArgs p;
  int bad = make_args(&p, plan, n_fields, KIND_PAIRS, bind_a, ets_a, valid_a,
                      bind_b, ets_b, valid_b, window, spec);
  if (bad) return bad;
  const long long* P = plan;
  const PairKernel count = CJ_TABLE[P[P_SHAPE]][window != nullptr].count;
  const EmitKernel emit = CJ_TABLE[P[P_SHAPE]][window != nullptr].emit;
  cudaStream_t st = (cudaStream_t)stream;
  const long long S = P[P_SLOTS], nt = P[P_NT], nrt = P[P_NRT];
  int32_t* counts = (int32_t*)scratch;
  int32_t* offsets = counts + S * p.ca * nt;
  int32_t* blocksum = offsets + S * p.ca * nt;
  const long long smem = P[P_SMEM];
  int e = set_smem((const void*)count, smem);
  if (!e) e = set_smem((const void*)emit, smem);
  if (e) return e;
  const dim3 grid((unsigned)nrt, (unsigned)nt, (unsigned)S);
  count<<<grid, CJ_THREADS, (size_t)smem, st>>>(p, counts, blocksum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cj_scan<<<dim3((unsigned)nrt, (unsigned)S), CJ_SCAN_THREADS, 0, st>>>(
      counts, offsets, blocksum, (int64_t*)a_out, (int64_t*)b_out,
      (uint8_t*)v_out, (int32_t*)n_dropped, p.ca, p.at, p.nt, p.nrt,
      p.max_new);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  emit<<<grid, CJ_THREADS, (size_t)smem, st>>>(
      p, counts, offsets, (int64_t*)a_out, (int64_t*)b_out, (uint8_t*)v_out);
  return (int)cudaGetLastError();
}

// compat_mask_launch: out is uint8 [S, ca, cb]; every byte is written.
extern "C" int compat_mask_launch(
    const void* bind_a, const void* ets_a, const void* valid_a,
    const void* bind_b, const void* ets_b, const void* valid_b,
    const void* window, const long long* plan, int n_fields,
    const uint32_t* spec, void* out, void* stream) {
  CJArgs p;
  int bad = make_args(&p, plan, n_fields, KIND_MASK, bind_a, ets_a, valid_a,
                      bind_b, ets_b, valid_b, window, spec);
  if (bad) return bad;
  const long long* P = plan;
  const MaskKernel mask = CJ_TABLE[P[P_SHAPE]][window != nullptr].mask;
  const long long smem = P[P_SMEM];
  int e = set_smem((const void*)mask, smem);
  if (e) return e;
  const dim3 grid((unsigned)P[P_NRT], (unsigned)P[P_NT],
                  (unsigned)P[P_SLOTS]);
  mask<<<grid, CJ_THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      p, (uint8_t*)out);
  return (int)cudaGetLastError();
}
