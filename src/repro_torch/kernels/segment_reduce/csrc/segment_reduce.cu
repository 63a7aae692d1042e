// Segment sum of edge messages into node rows, for Hopper (sm_90a): a
// node-tiled reduction in shared memory.
//
// Replaces the TPU kernel src/repro/kernels/segment_reduce/kernel.py:
// segment_sum_kernel.  A TPU has no scatter atomics, so that kernel is a
// blocked one-hot matmul on the MXU: for each tile of TN nodes it walks
// every edge tile and adds onehot(dst == node) @ msg into a VMEM
// accumulator, which costs N/TN passes over the messages.  Here each node
// tile keeps its accumulator on chip too, but visits only its own edges,
// found by bucketing the edge ids by tile first:
//
//   1. sr_bucket<false>: edges per tile (tile = dst / TN).  Lanes of a warp
//      whose edges fall in one tile add their count with one atomic
//      (__match_any_sync), so a run of a hub's edges costs one per warp.
//      When the tile counters fit in shared memory (TN x 24,576 nodes),
//      each block counts one chunk of the edges there and adds its counts
//      to device memory once per tile: a hub's edges never serialise on
//      one device address.
//   2. sr_scan: one block scans the tile counts into bucket offsets, the
//      cursor of each bucket, and the tile's pieces: a tile with c edges is
//      cut into max(1, ceil(c / CH)) pieces of at most CH edges, listed in
//      ptile (piece -> tile).  Tiles with more than CH edges (the hub
//      tiles) are numbered (moff) for their float32 scratch.
//   3. sr_bucket<true>: each edge id goes into its tile's bucket (order)
//      with its row in the tile (lrow, a byte); the atomics aggregate as in
//      1 (with shared memory, a block reserves one range of a bucket for
//      its many edges of a hub's tile and places them with shared-memory
//      atomics).  sr_zero then zeroes the hub tiles' scratch and done
//      counters.
//   4. sr_accum: one block per piece and column chunk.  The block sorts its
//      piece's edge ids by row in shared memory (counting sort over TN
//      rows), so each row's edges are one run; each group of lanes takes a
//      contiguous share of the sorted run, reads message rows with VEC-byte
//      loads (8 or 16 in flight), keeps the sum in registers while the row
//      stays the same, and adds it into a float32 TN x DC accumulator in
//      shared memory when the row changes (once per row and group, so the
//      shared-memory atomics are few).  A tile of one piece is then
//      written once, straight in the message dtype (zeros where no edge
//      landed).  A hub tile's pieces add their non-zero sums into the
//      tile's float32 scratch with global atomics; the piece that finishes
//      last (a done counter per tile and column chunk) casts the scratch
//      into the output.
//
// No step synchronises with the host and every grid size follows from E, N
// and D: sr_accum's grid is the most pieces E and N allow (tiles + E / CH);
// blocks past the actual count leave at once.  A row wider than DC
// columns is cut into column chunks, a grid dimension, so any D is taken.
// dst < 0 and dst >= N are dropped.  The sum order inside a tile follows
// the bucket order, which the atomics decide, so float32 sums agree with a
// sequential sum to rounding (integer-valued messages: exactly).
//
// What bounds it on an H100: bytes.  The messages are read once (E x D;
// 12.2 GB for the GIN path's first layer at the ogbn-products shape, bf16,
// D = 100), dst three times, the bucket list (5 bytes an edge) written
// and read once, and the N x D output written once, with no float32
// accumulator in device memory outside the hub tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define SR_THREADS 256
#define SR_SCAN_THREADS 1024
#define SR_TN_MAX 256        // rows per tile: a row index is one byte
#define SR_HOT 32            // a block's edges of one tile worth a range
#define SR_BATCH 4           // groups of 32 edges a warp walks at once
#define SR_BUCKET_THREADS 1024   // a block of the edge walks, at most
#define SR_FULL 0xffffffffu

// The launch plan, an int64 array in this order (kernel.py PLAN_FIELDS).
enum {
  P_E, P_N, P_D, P_DTYPE, P_VEC, P_TN, P_DC, P_N_CC, P_LR, P_CH, P_TILES,
  P_P_MAX, P_M_MAX, P_SMEM, P_PRIV, P_GRID_EDGES, P_WS_CNT, P_WS_OFF,
  P_WS_POFF, P_WS_MOFF, P_WS_PTILE, P_WS_DONE, P_WS_META, P_WS_ORDER,
  P_WS_LROW, P_WS_SCRATCH, P_WS_BYTES, P_COUNT
};

template <int VEC> struct VecOf;
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<4> { using type = unsigned int; };
template <> struct VecOf<2> { using type = unsigned short; };

template <typename T, int VEC>
union Pack {
  typename VecOf<VEC>::type v;
  T e[VEC / sizeof(T)];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float& y, float x) { y = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16& y, float x) {
  y = __float2bfloat16(x);
}

__device__ __forceinline__ int n_pieces(int c, int ch) {
  return c > 0 ? (c - 1) / ch + 1 : 1;
}

// The tile of edge i: dst >> tn_log2, or -1 for a dropped edge (or i >= e).
__device__ __forceinline__ int edge_tile(const int32_t* __restrict__ dst,
                                         long long i, long long e, int n,
                                         int tn_log2, int& v) {
  v = i < e ? dst[i] : -1;
  return v >= 0 && v < n ? v >> tn_log2 : -1;
}

// Steps 1 and 3 walk the edges a warp's 32 at a time; lanes whose edges
// share a tile make one atomic (their leader's) and rank themselves in it.
// PRIVATE (the tile counters fit in shared memory): each block walks one
// contiguous chunk of the edges and counts it in shared memory first.  The
// count adds each tile's total to device memory once per block.  The
// scatter reserves a range of the bucket once per block for each tile
// with at least SR_HOT edges in the chunk (a hub's tile: its edges then
// cost shared-memory atomics only) and places the other tiles' edges
// through the device cursor, so that the few open ends of each bucket stay
// in L2 and its writes combine there.  Otherwise every warp aggregates
// into the device counters directly.
template <bool SCATTER, bool PRIVATE>
__global__ void __launch_bounds__(SR_BUCKET_THREADS)
sr_bucket(const int32_t* __restrict__ dst, int* __restrict__ cnt,
          int* __restrict__ order, uint8_t* __restrict__ lrow,
          long long e, int n, int tn_log2, int tiles) {
  extern __shared__ int s_cnt[];              // [tiles] when PRIVATE
  const int tid = threadIdx.x, lane = tid & 31, nt = blockDim.x;
  long long hi = e, step = (long long)gridDim.x * nt;
  long long first = (long long)blockIdx.x * nt + (tid & ~31);
  if (PRIVATE) {
    const long long chunk = ((e + gridDim.x - 1) / gridDim.x + 31) & ~31LL;
    first = (long long)blockIdx.x * chunk;
    hi = min(e, first + chunk);
    first += tid & ~31;
    step = nt;
    for (int t = tid; t < tiles; t += nt) s_cnt[t] = 0;
    __syncthreads();
  }
  // A warp takes SR_BATCH groups of 32 edges at once (the loads, then the
  // atomics, are independent): the walk is bound by latency otherwise.
  if (PRIVATE || !SCATTER) {                  // count the edges per tile
    for (long long i0 = first; i0 < hi; i0 += step * SR_BATCH) {
      int v[SR_BATCH], tile[SR_BATCH];
#pragma unroll
      for (int b = 0; b < SR_BATCH; ++b)
        tile[b] = edge_tile(dst, i0 + b * step + lane, hi, n, tn_log2, v[b]);
#pragma unroll
      for (int b = 0; b < SR_BATCH; ++b) {
        const unsigned peers = __match_any_sync(SR_FULL, tile[b]);
        if (tile[b] >= 0 && lane == __ffs(peers) - 1)
          atomicAdd((PRIVATE ? s_cnt : cnt) + tile[b], __popc(peers));
      }
    }
    if (!PRIVATE) return;
    __syncthreads();
    for (int t = tid; t < tiles; t += nt) {
      const int c = s_cnt[t];
      if (c == 0) continue;
      if (!SCATTER) atomicAdd(cnt + t, c);
      else s_cnt[t] = c >= SR_HOT ? atomicAdd(cnt + t, c) : -1;  // own range
    }
    if (!SCATTER) return;
    __syncthreads();
  }
  for (long long i0 = first; i0 < hi; i0 += step * SR_BATCH) {  // place
    int v[SR_BATCH], tile[SR_BATCH], base[SR_BATCH];
    unsigned peers[SR_BATCH];
#pragma unroll
    for (int b = 0; b < SR_BATCH; ++b)
      tile[b] = edge_tile(dst, i0 + b * step + lane, hi, n, tn_log2, v[b]);
#pragma unroll
    for (int b = 0; b < SR_BATCH; ++b) {
      peers[b] = __match_any_sync(SR_FULL, tile[b]);
      base[b] = 0;
      if (tile[b] >= 0 && lane == __ffs(peers[b]) - 1)  // a private range
        base[b] = atomicAdd(                            // never goes below 0
            PRIVATE && s_cnt[tile[b]] >= 0 ? s_cnt + tile[b] : cnt + tile[b],
            __popc(peers[b]));
    }
#pragma unroll
    for (int b = 0; b < SR_BATCH; ++b) {
      const int pos = __shfl_sync(SR_FULL, base[b], __ffs(peers[b]) - 1) +
                      __popc(peers[b] & ((1u << lane) - 1u));
      if (tile[b] >= 0) {
        order[pos] = (int)(i0 + b * step + lane);
        lrow[pos] = (uint8_t)(v[b] - (tile[b] << tn_log2));
      }
    }
  }
}

__global__ void __launch_bounds__(SR_THREADS)
sr_zero(float* __restrict__ scratch, int* __restrict__ done,
        const int* __restrict__ meta, long long per_tile, int n_cc) {
  const long long m = meta[1];                 // hub tiles
  const long long step = (long long)gridDim.x * SR_THREADS;
  const long long first = (long long)blockIdx.x * SR_THREADS + threadIdx.x;
  for (long long k = first; k < m * per_tile; k += step) scratch[k] = 0.f;
  for (long long k = first; k < m * n_cc; k += step) done[k] = 0;
}

__global__ void __launch_bounds__(SR_SCAN_THREADS)
sr_scan(int* __restrict__ cnt, int* __restrict__ off, int* __restrict__ poff,
        int* __restrict__ moff, int* __restrict__ ptile,
        int* __restrict__ meta, int tiles, int ch) {
  __shared__ int s_tot[3][SR_SCAN_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (tiles + SR_SCAN_THREADS - 1) / SR_SCAN_THREADS;
  const int t0 = min(tiles, tid * per), t1 = min(tiles, t0 + per);
  int v[3] = {0, 0, 0};                         // edges, pieces, hub tiles
  for (int t = t0; t < t1; ++t) {
    const int c = cnt[t];
    v[0] += c;
    v[1] += n_pieces(c, ch);
    v[2] += c > ch;
  }
  int inc[3] = {v[0], v[1], v[2]};
  for (int o = 1; o < 32; o <<= 1)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int x = __shfl_up_sync(SR_FULL, inc[q], o);
      if (lane >= o) inc[q] += x;
    }
  if (lane == 31)
    for (int q = 0; q < 3; ++q) s_tot[q][warp] = inc[q];
  __syncthreads();
  if (warp == 0) {
    int w[3] = {s_tot[0][lane], s_tot[1][lane], s_tot[2][lane]};
    int wi[3] = {w[0], w[1], w[2]};
    for (int o = 1; o < 32; o <<= 1)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int x = __shfl_up_sync(SR_FULL, wi[q], o);
        if (lane >= o) wi[q] += x;
      }
    for (int q = 0; q < 3; ++q) s_tot[q][lane] = wi[q] - w[q];
  }
  __syncthreads();
  int c = inc[0] - v[0] + s_tot[0][warp];       // exclusive prefixes
  int p = inc[1] - v[1] + s_tot[1][warp];
  int m = inc[2] - v[2] + s_tot[2][warp];
  for (int t = t0; t < t1; ++t) {
    const int x = cnt[t], np = n_pieces(x, ch);
    off[t] = c;
    cnt[t] = c;                                 // the bucket's cursor
    poff[t] = p;
    moff[t] = x > ch ? m : -1;
    for (int j = 0; j < np; ++j) ptile[p + j] = t;
    c += x;
    p += np;
    m += x > ch;
  }
  if (tid == SR_SCAN_THREADS - 1) {
    off[tiles] = c;
    poff[tiles] = p;
    meta[0] = p;
    meta[1] = m;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(SR_THREADS)
sr_accum(const T* __restrict__ msg, T* __restrict__ out,
         const int* __restrict__ off, const int* __restrict__ poff,
         const int* __restrict__ moff, const int* __restrict__ ptile,
         const int* __restrict__ meta, const int* __restrict__ order,
         const uint8_t* __restrict__ lrow, float* __restrict__ scratch,
         int* __restrict__ done, int n, int d, int tn, int dc, int n_cc,
         int lr, int ch) {
  using V = typename VecOf<VEC>::type;
  constexpr int VE = VEC / (int)sizeof(T);
  constexpr int U = VEC >= 16 ? 8 : 16;         // row loads in flight
  extern __shared__ float s_acc[];              // [tn][dc], then s_edge
  int* s_edge = reinterpret_cast<int*>(s_acc + tn * dc);   // [ch]
  __shared__ int s_start[SR_TN_MAX + 1];        // rows' starts in s_edge
  __shared__ int s_cur[SR_TN_MAX];
  __shared__ int s_last;
  const int piece = blockIdx.x;
  if (piece >= meta[0]) return;                 // past the actual pieces
  const int t = ptile[piece];
  const int np = poff[t + 1] - poff[t];
  const int ps = off[t] + (piece - poff[t]) * ch;
  const int cnt = min(off[t + 1] - ps, ch);     // this piece's edges
  const int m = moff[t];                        // >= 0: a hub tile
  const long long row0 = (long long)t * tn;
  const int rows = (int)min((long long)tn, n - row0);
  const int tid = threadIdx.x, lane = tid & 31;

  // Sort the piece's edges by row (a counting sort in shared memory), so
  // that each row's edges are one run.
  for (int r = tid; r < tn; r += SR_THREADS) s_cur[r] = 0;
  __syncthreads();
  for (int i0 = tid & ~31; i0 < cnt; i0 += SR_THREADS * SR_BATCH) {
    int r[SR_BATCH];
#pragma unroll
    for (int b = 0; b < SR_BATCH; ++b) {
      const int i = i0 + b * SR_THREADS + lane;
      r[b] = i < cnt ? lrow[ps + i] : -1;
    }
#pragma unroll
    for (int b = 0; b < SR_BATCH; ++b) {
      const unsigned peers = __match_any_sync(SR_FULL, r[b]);
      if (r[b] >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(s_cur + r[b], __popc(peers));
    }
  }
  __syncthreads();
  if (tid < 32) {                               // exclusive scan over rows
    const int per = (tn + 31) / 32, r0 = min(tn, lane * per);
    const int r1 = min(tn, r0 + per);
    int sum = 0;
    for (int r = r0; r < r1; ++r) sum += s_cur[r];
    int inc = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(SR_FULL, inc, o);
      if (lane >= o) inc += x;
    }
    int at = inc - sum;
    for (int r = r0; r < r1; ++r) {
      const int c = s_cur[r];
      s_start[r] = at;
      s_cur[r] = at;
      at += c;
    }
    if (lane == 31) s_start[tn] = at;
  }
  __syncthreads();
  for (int i0 = tid & ~31; i0 < cnt; i0 += SR_THREADS * SR_BATCH) {
    int r[SR_BATCH], e[SR_BATCH];
#pragma unroll
    for (int b = 0; b < SR_BATCH; ++b) {
      const int i = i0 + b * SR_THREADS + lane;
      r[b] = i < cnt ? lrow[ps + i] : -1;
      e[b] = i < cnt ? order[ps + i] : 0;
    }
#pragma unroll
    for (int b = 0; b < SR_BATCH; ++b) {
      const unsigned peers = __match_any_sync(SR_FULL, r[b]);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (r[b] >= 0 && lane == leader)
        base = atomicAdd(s_cur + r[b], __popc(peers));
      base = __shfl_sync(SR_FULL, base, leader);
      if (r[b] >= 0)
        s_edge[base + __popc(peers & ((1u << lane) - 1u))] = e[b];
    }
  }

  // Each lane group takes one contiguous run of the sorted edges.
  const int groups = SR_THREADS / lr, col = (tid & (lr - 1)) * VE;
  const int per = (cnt + groups - 1) / groups;
  const int gs = min(cnt, (tid / lr) * per), ge = min(cnt, gs + per);
  for (int cc = blockIdx.y; cc < n_cc; cc += gridDim.y) {
    const int c0 = cc * dc, w = min(dc, d - c0);   // this chunk's columns
    for (int k = tid; k < tn * dc; k += SR_THREADS) s_acc[k] = 0.f;
    __syncthreads();                            // also orders s_edge
    const bool active = col < w;
    const T* base = msg + c0 + col;
    float acc[VE];
#pragma unroll
    for (int q = 0; q < VE; ++q) acc[q] = 0.f;
    int cur = 0, hi = tn - 1;                   // the row of position gs:
    while (cur < hi) {                          // the last starting <= gs
      const int mid = (cur + hi + 1) / 2;
      if (s_start[mid] <= gs) cur = mid; else hi = mid - 1;
    }
    int next = s_start[cur + 1];                // where row `cur` ends
    for (int i = gs; i < ge; i += U) {
      Pack<T, VEC> x[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (active && i + u < ge)
          x[u].v = *reinterpret_cast<const V*>(
              base + (long long)s_edge[i + u] * d);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i + u >= ge) break;
        if (i + u >= next) {                    // a new row: flush the sum
          if (active)
#pragma unroll
            for (int q = 0; q < VE; ++q) {
              atomicAdd(s_acc + cur * dc + col + q, acc[q]);
              acc[q] = 0.f;
            }
          while (i + u >= next) next = s_start[++cur + 1];
        }
        if (active)
#pragma unroll
          for (int q = 0; q < VE; ++q) acc[q] += to_f32(x[u].e[q]);
      }
    }
    if (active && gs < ge)
#pragma unroll
      for (int q = 0; q < VE; ++q)
        atomicAdd(s_acc + cur * dc + col + q, acc[q]);
    __syncthreads();
    const int total = rows * w;     // w is a multiple of VE: rows stay whole
    float* sc = scratch + (long long)(m < 0 ? 0 : m) * tn * d;
    bool write = m < 0;
    if (m >= 0) {
      for (int k = tid; k < total; k += SR_THREADS) {
        const int r = k / w, c = k - r * w;
        const float val = s_acc[r * dc + c];
        if (val != 0.f) atomicAdd(sc + (long long)r * d + c0 + c, val);
      }
      __threadfence();
      __syncthreads();
      if (tid == 0)
        s_last = atomicAdd(done + (long long)m * n_cc + cc, 1) == np - 1;
      __syncthreads();
      write = s_last;
      if (write) __threadfence();
    }
    if (write) {
      for (int k = tid * VE; k < total; k += SR_THREADS * VE) {
        const int r = k / w, c = k - r * w;
        Pack<T, VEC> y;
#pragma unroll
        for (int q = 0; q < VE; ++q)
          from_f32(y.e[q], m < 0 ? s_acc[r * dc + c + q]
                                 : __ldcg(sc + (long long)r * d + c0 + c + q));
        *reinterpret_cast<V*>(out + (row0 + r) * d + c0 + c) = y.v;
      }
    }
    __syncthreads();              // s_acc and s_last serve the next chunk
  }
}

template <typename T, int VEC>
static cudaError_t accum(const long long* P, const void* msg, void* out,
                         char* ws, cudaStream_t st) {
  // Past 48 KB of shared memory (static included) a kernel must opt in.
  const int smem = (int)P[P_SMEM];
  cudaError_t e = cudaFuncSetAttribute(
      sr_accum<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)P[P_P_MAX],
                  (unsigned)(P[P_N_CC] < 65535 ? P[P_N_CC] : 65535));
  sr_accum<T, VEC><<<grid, SR_THREADS, smem, st>>>(
      (const T*)msg, (T*)out, (const int*)(ws + P[P_WS_OFF]),
      (const int*)(ws + P[P_WS_POFF]), (const int*)(ws + P[P_WS_MOFF]),
      (const int*)(ws + P[P_WS_PTILE]), (const int*)(ws + P[P_WS_META]),
      (const int*)(ws + P[P_WS_ORDER]), (const uint8_t*)(ws + P[P_WS_LROW]),
      (float*)(ws + P[P_WS_SCRATCH]), (int*)(ws + P[P_WS_DONE]),
      (int)P[P_N], (int)P[P_D], (int)P[P_TN], (int)P[P_DC], (int)P[P_N_CC],
      (int)P[P_LR], (int)P[P_CH]);
  return cudaGetLastError();
}

template <bool SCATTER>
static cudaError_t bucket(const long long* P, const void* dst, char* ws,
                          cudaStream_t st) {
  const int tiles = (int)P[P_TILES];
  int* cnt = (int*)(ws + P[P_WS_CNT]);
  int* order = SCATTER ? (int*)(ws + P[P_WS_ORDER]) : nullptr;
  uint8_t* lrow = SCATTER ? (uint8_t*)(ws + P[P_WS_LROW]) : nullptr;
  const unsigned grid = (unsigned)P[P_GRID_EDGES];
  const int tn_log2 = __builtin_ctz((unsigned)P[P_TN]);
  if (!P[P_PRIV]) {
    sr_bucket<SCATTER, false><<<grid, SR_THREADS, 0, st>>>(
        (const int32_t*)dst, cnt, order, lrow, P[P_E], (int)P[P_N], tn_log2,
        tiles);
    return cudaGetLastError();
  }
  // one block of SR_BUCKET_THREADS on each SM: the counters fill most of
  // its shared memory, so the warps come from the block's size
  const int smem = tiles * 4;
  cudaError_t e = cudaFuncSetAttribute(
      sr_bucket<SCATTER, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  sr_bucket<SCATTER, true><<<grid, SR_BUCKET_THREADS, smem, st>>>(
      (const int32_t*)dst, cnt, order, lrow, P[P_E], (int)P[P_N], tn_log2,
      tiles);
  return cudaGetLastError();
}

// Plain C entry point, bound with ctypes.  dst int32 [e], msg [e, d] of the
// plan's dtype (0 = float32, 1 = bfloat16), out [n, d] of the same dtype,
// ws a device workspace of plan[P_WS_BYTES] bytes; every pointer is device
// memory.  `plan` (host memory, P_COUNT int64 values) is kernel.py's
// plan().  Returns the first CUDA error of the launches (0 = ok).
extern "C" int segment_sum_launch(const void* dst, const void* msg, void* out,
                                  void* ws, const long long* plan,
                                  int n_fields, void* stream) {
  if (n_fields != P_COUNT) return (int)cudaErrorInvalidValue;
  const long long* P = plan;
  const long long e = P[P_E], n = P[P_N], d = P[P_D], dtype = P[P_DTYPE];
  const long long vec = P[P_VEC], tn = P[P_TN], dc = P[P_DC];
  const long long elem = dtype == 0 ? 4 : 2;
  if (e < 0 || e >= (1LL << 31) || n < 1 || n >= (1LL << 31) || d < 1 ||
      d >= (1LL << 31) || dtype < 0 || dtype > 1 || vec < elem ||
      (d * elem) % vec || ((uintptr_t)msg) % vec || tn < 1 ||
      tn > SR_TN_MAX || (tn & (tn - 1)) || dc < 1 || dc > d || dc % (vec / elem) ||
      P[P_LR] * (vec / elem) < dc || P[P_LR] > 32 ||
      (P[P_LR] & (P[P_LR] - 1)) || P[P_N_CC] * dc < d || P[P_CH] < 1 ||
      P[P_SMEM] != (tn * dc + P[P_CH]) * 4 || P[P_SMEM] > 232448 ||
      P[P_TILES] != (n + tn - 1) / tn ||
      (P[P_PRIV] && P[P_TILES] * 4 > 232448) ||
      P[P_P_MAX] < P[P_TILES] + e / P[P_CH] || P[P_P_MAX] >= (1LL << 31) ||
      P[P_GRID_EDGES] < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  char* w = (char*)ws;
  const int tiles = (int)P[P_TILES];
  cudaError_t err = cudaMemsetAsync(w + P[P_WS_CNT], 0, (size_t)tiles * 4, st);
  if (err != cudaSuccess) return (int)err;
  if (e > 0 && (err = bucket<false>(P, dst, w, st)) != cudaSuccess)
    return (int)err;
  sr_scan<<<1, SR_SCAN_THREADS, 0, st>>>(
      (int*)(w + P[P_WS_CNT]), (int*)(w + P[P_WS_OFF]),
      (int*)(w + P[P_WS_POFF]), (int*)(w + P[P_WS_MOFF]),
      (int*)(w + P[P_WS_PTILE]), (int*)(w + P[P_WS_META]), tiles,
      (int)P[P_CH]);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (e > 0) {
    if ((err = bucket<true>(P, dst, w, st)) != cudaSuccess) return (int)err;
    if (P[P_M_MAX] > 0) {
      sr_zero<<<(unsigned)P[P_GRID_EDGES], SR_THREADS, 0, st>>>(
          (float*)(w + P[P_WS_SCRATCH]), (int*)(w + P[P_WS_DONE]),
          (const int*)(w + P[P_WS_META]), tn * d, (int)P[P_N_CC]);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  if (dtype == 0) {
    switch (vec) {
      case 16: err = accum<float, 16>(P, msg, out, w, st); break;
      case 8: err = accum<float, 8>(P, msg, out, w, st); break;
      case 4: err = accum<float, 4>(P, msg, out, w, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (vec) {
      case 16: err = accum<__nv_bfloat16, 16>(P, msg, out, w, st); break;
      case 8: err = accum<__nv_bfloat16, 8>(P, msg, out, w, st); break;
      case 4: err = accum<__nv_bfloat16, 4>(P, msg, out, w, st); break;
      case 2: err = accum<__nv_bfloat16, 2>(P, msg, out, w, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)err;
}
