// Fused compatibility join with pair compaction, for Hopper (sm_90a).
//
// Replaces the TPU kernels in src/repro/kernels/compat_join/kernel.py:
//   * compat_join_pairs_kernel          (body _pairs_body, predicate _tile_mask)
//   * compat_join_pairs_kernel_batched  (the same over a slot axis)
// Both become one launch over a slot axis here: a single join is S = 1, and
// every operand carries a slot stride that is 0 when the operand is shared
// across the slots (a slot group's level joins share the stream-edge side),
// so a shared operand is read once per slot from cache instead of being
// broadcast S times through device memory.
//
// What it computes, per slot s: every pair (a, b) of rows of table A [CA]
// and table B [CB] that satisfies the join predicate
//   valid_a[a] && valid_b[b]
//   && for all vertex slot pairs (i, j): rel[i][j] ? bind_a[a,i] == bind_b[b,j]
//                                                  : bind_a[a,i] != bind_b[b,j]
//   && for all edge slot pairs (i, j): trel[i][j] == -1 -> ets_a[a,i] < ets_b[b,j]
//                                      trel[i][j] == +1 -> ets_a[a,i] > ets_b[b,j]
//   && (no window || max(all ts) - min(all ts) < window[s])   (int32, wrapping)
// written as (a_idx, b_idx) into [S, max_new] outputs (pre-filled with -1 by
// the caller) plus the exact total n_total[s].  The [CA, CB] mask is never
// written to memory.
//
// What bounds it on an H100: the predicate's int32 compare work, about
// (valid A rows) x (valid B rows) x (NVA*NVB + #TREL != 0 + ~4 window ops)
// per slot.  The tables are narrow: a 65536 x 4096 level join reads under
// 2 MB, so the bytes are far below the compare work at the memory rate.
//
// Design.  The TPU kernel walks its grid in order and carries an output
// cursor in SMEM from tile to tile.  Hopper blocks run concurrently and in
// no order, so the cursor becomes three passes:
//   1. count: one warp per A row; the warp walks B 32 columns at a time, each
//      lane evaluates one (a, b), __ballot_sync + __popc give the row's
//      match count.  An invalid A row costs one load; a 32-column chunk with
//      no valid B row is skipped after one __any_sync.
//   2. scan:  one block per slot turns the row counts into exclusive row
//      offsets and the slot's total.
//   3. emit:  rows with matches re-evaluate their chunks; lane k of a chunk
//      writes its pair at offset[a] + (matches before this chunk) +
//      popc(ballot & lanes below k), while that is < max_new.
// Pairs therefore come out in row-major order of the mask, exactly the
// order of the plain version's nonzero, so kernel and plain version agree
// element for element, overflow included.  The spec (REL/TREL) is runtime
// data in the by-value argument struct, staged into shared memory.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define CJ_MAX_NV 16
#define CJ_MAX_NE 16
#define CJ_WARPS 8                 // A rows (warps) per block
#define CJ_SCAN_THREADS 1024
#define CJ_FULL 0xffffffffu

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
  int has_window, max_new;
  int8_t rel[CJ_MAX_NV * CJ_MAX_NV];     // row-major [nva][nvb], 1 = same vertex
  int8_t trel[CJ_MAX_NE * CJ_MAX_NE];    // row-major [nea][neb], -1 / 0 / +1
};

// Per-block staging: the spec, and each warp's A row (bind then ets).
struct CJShared {
  int8_t rel[CJ_MAX_NV * CJ_MAX_NV];
  int8_t trel[CJ_MAX_NE * CJ_MAX_NE];
  int32_t a_bind[CJ_WARPS][CJ_MAX_NV];
  int32_t a_ets[CJ_WARPS][CJ_MAX_NE];
};

__device__ __forceinline__ int32_t wrap_sub(int32_t x, int32_t y) {
  return (int32_t)((uint32_t)x - (uint32_t)y);
}

// Stage the spec and this warp's A row; returns valid_a[a] (0 past CA).
__device__ __forceinline__ int stage(const CJArgs& p, CJShared& sh, int s,
                                     int a, int warp, int lane) {
  for (int t = threadIdx.x; t < p.nva * p.nvb; t += blockDim.x)
    sh.rel[t] = p.rel[t];
  for (int t = threadIdx.x; t < p.nea * p.neb; t += blockDim.x)
    sh.trel[t] = p.trel[t];
  int va = 0;
  if (a < p.ca) {
    const int32_t* ba = p.bind_a + s * p.sa_bind + (long long)a * p.nva;
    const int32_t* ea = p.ets_a + s * p.sa_ets + (long long)a * p.nea;
    if (lane < p.nva) sh.a_bind[warp][lane] = ba[lane];
    if (lane < p.nea) sh.a_ets[warp][lane] = ea[lane];
    va = p.valid_a[s * p.sa_valid + a] != 0;
  }
  __syncthreads();
  return va;
}

// The join predicate for (this warp's A row, B row b); b must be < CB.
__device__ __forceinline__ bool pred(const CJArgs& p, const CJShared& sh,
                                     int s, int warp, int b, int a_min,
                                     int a_max, int w) {
  const int32_t* bb = p.bind_b + s * p.sb_bind + (long long)b * p.nvb;
  const int32_t* eb = p.ets_b + s * p.sb_ets + (long long)b * p.neb;
  const int32_t* ab = sh.a_bind[warp];
  const int32_t* ae = sh.a_ets[warp];
  bool ok = true;
  for (int j = 0; j < p.nvb; ++j) {
    int32_t bj = bb[j];
    for (int i = 0; i < p.nva; ++i) {
      bool eq = ab[i] == bj;
      ok &= sh.rel[i * p.nvb + j] ? eq : !eq;
    }
  }
  int b_min = eb[0], b_max = eb[0];
  for (int j = 0; j < p.neb; ++j) {
    int32_t tj = eb[j];
    b_min = min(b_min, tj);
    b_max = max(b_max, tj);
    for (int i = 0; i < p.nea; ++i) {
      int8_t r = sh.trel[i * p.neb + j];
      if (r == -1) ok &= ae[i] < tj;
      else if (r == 1) ok &= ae[i] > tj;
    }
  }
  if (p.has_window)
    ok &= wrap_sub(max(a_max, b_max), min(a_min, b_min)) < w;
  return ok;
}

__device__ __forceinline__ void a_span(const CJShared& sh, int warp, int nea,
                                       int* lo, int* hi) {
  int mn = sh.a_ets[warp][0], mx = sh.a_ets[warp][0];
  for (int i = 1; i < nea; ++i) {
    mn = min(mn, sh.a_ets[warp][i]);
    mx = max(mx, sh.a_ets[warp][i]);
  }
  *lo = mn;
  *hi = mx;
}

__global__ void __launch_bounds__(CJ_WARPS * 32)
cj_count(const CJArgs p, int32_t* __restrict__ counts) {
  __shared__ CJShared sh;
  const int s = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a = blockIdx.x * CJ_WARPS + warp;
  const int va = stage(p, sh, s, a, warp, lane);
  if (a >= p.ca) return;                       // warp-uniform, after the sync
  int cnt = 0;
  if (va) {
    int a_min, a_max;
    a_span(sh, warp, p.nea, &a_min, &a_max);
    const int w = p.has_window ? p.window[s] : 0;
    const uint8_t* vb = p.valid_b + s * p.sb_valid;
    for (int b0 = 0; b0 < p.cb; b0 += 32) {
      const int b = b0 + lane;
      bool ok = b < p.cb && vb[b];
      if (!__any_sync(CJ_FULL, ok)) continue;
      if (ok) ok = pred(p, sh, s, warp, b, a_min, a_max, w);
      cnt += __popc(__ballot_sync(CJ_FULL, ok));
    }
  }
  if (lane == 0) counts[(long long)s * p.ca + a] = cnt;
}

__global__ void __launch_bounds__(CJ_SCAN_THREADS)
cj_scan(const int32_t* __restrict__ counts, int32_t* __restrict__ offsets,
        int32_t* __restrict__ n_total, int ca) {
  __shared__ int32_t warp_sums[32];
  __shared__ int32_t total;
  const int s = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t* c = counts + (long long)s * ca;
  int32_t* o = offsets + (long long)s * ca;
  const int nthreads = (int)blockDim.x, tid = (int)threadIdx.x;
  const int per = (ca + nthreads - 1) / nthreads;
  const int lo = min(tid * per, ca), hi = min(lo + per, ca);
  int32_t sum = 0;
  for (int i = lo; i < hi; ++i) sum += c[i];
  int32_t incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    int32_t v = __shfl_up_sync(CJ_FULL, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = nthreads >> 5;
    const int32_t v = lane < nw ? warp_sums[lane] : 0;
    int32_t vi = v;
    for (int d = 1; d < 32; d <<= 1) {
      int32_t u = __shfl_up_sync(CJ_FULL, vi, d);
      if (lane >= d) vi += u;
    }
    warp_sums[lane] = vi - v;                  // exclusive per warp
    if (lane == 31) total = vi;
  }
  __syncthreads();
  int32_t run = warp_sums[warp] + incl - sum;  // exclusive per thread
  for (int i = lo; i < hi; ++i) {
    o[i] = run;
    run += c[i];
  }
  if (tid == 0) n_total[s] = total;
}

__global__ void __launch_bounds__(CJ_WARPS * 32)
cj_emit(const CJArgs p, const int32_t* __restrict__ counts,
        const int32_t* __restrict__ offsets, int32_t* __restrict__ a_out,
        int32_t* __restrict__ b_out) {
  __shared__ CJShared sh;
  const int s = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a = blockIdx.x * CJ_WARPS + warp;
  stage(p, sh, s, a, warp, lane);
  if (a >= p.ca) return;
  const long long row = (long long)s * p.ca + a;
  if (counts[row] == 0) return;
  int run = offsets[row];
  if (run >= p.max_new) return;
  int a_min, a_max;
  a_span(sh, warp, p.nea, &a_min, &a_max);
  const int w = p.has_window ? p.window[s] : 0;
  const uint8_t* vb = p.valid_b + s * p.sb_valid;
  int32_t* ao = a_out + (long long)s * p.max_new;
  int32_t* bo = b_out + (long long)s * p.max_new;
  const unsigned below = (1u << lane) - 1u;
  for (int b0 = 0; b0 < p.cb && run < p.max_new; b0 += 32) {
    const int b = b0 + lane;
    bool ok = b < p.cb && vb[b];
    if (!__any_sync(CJ_FULL, ok)) continue;
    if (ok) ok = pred(p, sh, s, warp, b, a_min, a_max, w);
    const unsigned m = __ballot_sync(CJ_FULL, ok);
    if (ok) {
      const int pos = run + __popc(m & below);
      if (pos < p.max_new) {
        ao[pos] = a;
        bo[pos] = b;
      }
    }
    run += __popc(m);
  }
}

// Plain C entry point, bound with ctypes.  rel / trel are HOST int8 arrays
// ([nva*nvb], [nea*neb]); every other pointer is device memory.  a_out /
// b_out must be pre-filled with -1.  Returns cudaGetLastError() (0 = ok).
extern "C" int compat_join_pairs_launch(
    const void* bind_a, const void* ets_a, const void* valid_a,
    const void* bind_b, const void* ets_b, const void* valid_b,
    const void* window,
    long long sa_bind, long long sa_ets, long long sa_valid,
    long long sb_bind, long long sb_ets, long long sb_valid,
    int n_slots, int ca, int cb, int nva, int nvb, int nea, int neb,
    int has_window, int max_new, const void* rel, const void* trel,
    void* counts, void* offsets, void* a_out, void* b_out, void* n_total,
    void* stream) {
  if (nva > CJ_MAX_NV || nvb > CJ_MAX_NV || nea > CJ_MAX_NE ||
      neb > CJ_MAX_NE || nva < 1 || nvb < 1 || nea < 1 || neb < 1 ||
      n_slots < 1 || n_slots > 65535 || ca < 1 || cb < 0 || max_new < 0)
    return (int)cudaErrorInvalidValue;
  CJArgs p;
  memset(&p, 0, sizeof(p));
  p.bind_a = (const int32_t*)bind_a;
  p.ets_a = (const int32_t*)ets_a;
  p.valid_a = (const uint8_t*)valid_a;
  p.bind_b = (const int32_t*)bind_b;
  p.ets_b = (const int32_t*)ets_b;
  p.valid_b = (const uint8_t*)valid_b;
  p.window = (const int32_t*)window;
  p.sa_bind = sa_bind; p.sa_ets = sa_ets; p.sa_valid = sa_valid;
  p.sb_bind = sb_bind; p.sb_ets = sb_ets; p.sb_valid = sb_valid;
  p.ca = ca; p.cb = cb; p.nva = nva; p.nvb = nvb; p.nea = nea; p.neb = neb;
  p.has_window = has_window;
  p.max_new = max_new;
  memcpy(p.rel, rel, (size_t)nva * nvb);
  memcpy(p.trel, trel, (size_t)nea * neb);
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((ca + CJ_WARPS - 1) / CJ_WARPS, n_slots);
  cj_count<<<grid, CJ_WARPS * 32, 0, st>>>(p, (int32_t*)counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cj_scan<<<n_slots, CJ_SCAN_THREADS, 0, st>>>(
      (const int32_t*)counts, (int32_t*)offsets, (int32_t*)n_total, ca);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cj_emit<<<grid, CJ_WARPS * 32, 0, st>>>(
      p, (const int32_t*)counts, (const int32_t*)offsets, (int32_t*)a_out,
      (int32_t*)b_out);
  return (int)cudaGetLastError();
}
