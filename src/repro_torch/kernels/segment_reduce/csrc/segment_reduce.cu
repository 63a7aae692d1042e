// Segment sum of edge messages into node rows, for Hopper (sm_90a), in
// one fixed order.
//
// Replaces the TPU kernel src/repro/kernels/segment_reduce/kernel.py:
// segment_sum_kernel.  That kernel walks the edge blocks of each node tile
// in sequence ("edge axis minor") into one float32 VMEM accumulator, so
// one input always gives the same bits.  This kernel keeps that property:
// its float32 sums follow one order, a function of dst and the edge index
// alone, that no atomic, grid size or block's timing decides.
//
// THE ORDER.  Node n's edges (dst[e] == n) are taken in ascending e and
// cut into runs of SR_RUN consecutive edges (the last run may be
// shorter).  Each run is summed left to right in float32 from +0; the
// node's sum is its run sums added left to right in float32 from +0,
// rounded once to the message dtype.  ref.py's segment_sum_ordered
// computes the same sums in plain torch, in the same words.
//
// The steps, one call, no host synchronisation; every grid follows from
// E, N and D:
//
//   1. A least-significant-digit radix sort of the edge ids by key (dst,
//      or N for a dropped id), SR_BITS bits a pass: sr_hist counts each
//      block's digits, sr_scan_hist scans each digit's counts over the
//      blocks, and sr_scatter places each edge at its digit's start for
//      its block plus its rank among the block's edges of that digit.  The
//      rank follows the edge index: each warp walks its own contiguous
//      part of a tile 32 edges at a time, finds the lanes of one digit by
//      SR_BITS ballots, ranks them by a popc of the lower lanes into
//      per-warp counters, and a scan over the warps adds the counts of the
//      warps before it.  The tile is put in order in shared memory and
//      written out digit run by digit run.  Every pass is stable, so the
//      sorted list holds each node's edges in ascending index.
//   2. sr_starts: each node's start in the sorted list, from where the
//      sorted keys change; start[N] counts the kept edges.
//   3. sr_runs: the runs of nodes with more than SR_RUN edges (hubs).  One
//      lane group takes a window of SR_RUN sorted positions.  At most two
//      hub runs start there: one of the node at the window's first
//      position, and the first run of a hub that starts inside the window
//      (it then covers the window's last position).  Each is summed into
//      its own float32 scratch row, 2 w or 2 w + 1.
//   4. sr_nodes: one lane group per piece of sorted positions and
//      column chunk, for the nodes whose first edge lies in the piece (so
//      that groups get about as many edges whatever the degrees).  A node
//      of at most SR_RUN edges (one run) is summed from its message rows,
//      which the group loads U at a time across node boundaries (16- and
//      8-byte loads) or node by node (narrower ones); a hub (SR_HUB on its
//      first sorted edge id, set by sr_starts) adds its run sums from
//      scratch in run order.  sr_empty writes the zeros of the nodes
//      without edges.  Each output row is written once, in the message
//      dtype.
//
// No step uses an atomic: no float is added out of the order above, and
// every position is a function of the keys.
//
// What bounds it on an H100: bytes.  The messages are read once (E x D;
// 12.2 GB for the GIN path's first layer at the ogbn-products shape, bf16,
// D = 100), the N x D output written once; the sort reads and writes a key
// and an edge id per edge and pass (3 passes below 2^24 nodes).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define SR_THREADS 256
#define SR_WARPS (SR_THREADS / 32)
#define SR_BITS 8             // key bits a radix pass
#define SR_BINS 256           // 1 << SR_BITS: one digit a thread of a block
#define SR_IPT 16             // edges a lane ranks in one tile
#define SR_TILE 4096          // SR_THREADS * SR_IPT: one tile of a sort block
#define SR_RUN 1024           // edges a run (THE ORDER)
#define SR_SCAN_THREADS 1024
#define SR_SCAN_IPT 8         // values a thread of the scan takes at a time
#define SR_FULL 0xffffffffu
#define SR_HUB ((int)0x80000000u)   // in a sorted edge id: a hub's first

static_assert(SR_BINS == SR_THREADS, "one digit a thread");
static_assert(SR_TILE == SR_THREADS * SR_IPT, "a tile");

// The launch plan, an int64 array in this order (kernel.py PLAN_FIELDS).
enum {
  P_E, P_N, P_D, P_DTYPE, P_VEC, P_DC, P_N_CC, P_LR, P_RUN, P_PASSES,
  P_SUB, P_NB, P_WINDOWS, P_PIECE, P_PIECES, P_GRID_NODES, P_GRID_PIECES,
  P_GRID_RUNS, P_GRID_STARTS,
  P_WS_HIST, P_WS_KEY0, P_WS_VAL0, P_WS_KEY1, P_WS_VAL1, P_WS_START,
  P_WS_SCRATCH, P_WS_BYTES, P_COUNT
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

// The sort key of edge i: dst, or n for an id outside [0, n).  The first
// pass reads dst itself; later passes the previous pass's keys.
template <bool FIRST>
__device__ __forceinline__ int key_at(const int32_t* __restrict__ keys,
                                      long long i, int n) {
  const int v = keys[i];
  return FIRST ? (v >= 0 && v < n ? v : n) : v;
}

// The lanes of the warp whose digit equals this lane's, among the lanes
// with `ok` (SR_BITS ballots; the result of a lane without `ok` is unused).
__device__ __forceinline__ unsigned same_digit(int dig, bool ok) {
  unsigned m = __ballot_sync(SR_FULL, ok);
#pragma unroll
  for (int b = 0; b < SR_BITS; ++b) {
    const unsigned ones = __ballot_sync(SR_FULL, (dig >> b) & 1);
    m &= (dig >> b) & 1 ? ones : ~ones;
  }
  return m;
}

// The exclusive sum of v over the block's threads before this one.
__device__ __forceinline__ int block_excl_sum(int v, int* s_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(SR_FULL, inc, o);
    if (lane >= o) inc += x;
  }
  if (lane == 31) s_sum[warp] = inc;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += s_sum[w];
  __syncthreads();                              // s_sum free again
  return before + inc - v;
}

// 1a. Each block counts the digits of its range of sub * SR_TILE edges,
// each warp into its own counters (its lanes of one digit add once).
template <bool FIRST>
__global__ void __launch_bounds__(SR_THREADS)
sr_hist(const int32_t* __restrict__ keys, int* __restrict__ hist,
        long long e, int n, int shift, int nb, int sub) {
  __shared__ int s_h[SR_WARPS][SR_BINS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int w = 0; w < SR_WARPS; ++w) s_h[w][tid] = 0;
  __syncthreads();
  const long long lo = (long long)blockIdx.x * sub * SR_TILE;
  const long long hi = min(e, lo + (long long)sub * SR_TILE);
  for (long long i0 = lo + warp * 32; i0 < hi; i0 += SR_THREADS * 4) {
    int dg[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const long long i = i0 + b * SR_THREADS + lane;
      dg[b] = i < hi ? (key_at<FIRST>(keys, i, n) >> shift) & (SR_BINS - 1)
                     : -1;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const unsigned peers = same_digit(dg[b], dg[b] >= 0);
      if (dg[b] >= 0 && lane == __ffs(peers) - 1)
        s_h[warp][dg[b]] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  int c = 0;
#pragma unroll
  for (int w = 0; w < SR_WARPS; ++w) c += s_h[w][tid];
  hist[(long long)tid * nb + blockIdx.x] = c;
}

// 1b. Block d: the exclusive scan of hist row d (its count in each block)
// in place, and the row's total at hist[SR_BINS * nb + d].
__global__ void __launch_bounds__(SR_SCAN_THREADS)
sr_scan_hist(int* __restrict__ hist, int nb) {
  constexpr int CHUNK = SR_SCAN_THREADS * SR_SCAN_IPT;
  __shared__ int s_v[CHUNK + CHUNK / 32];       // padded: no bank conflicts
  __shared__ int s_w[SR_SCAN_THREADS / 32];
  int* a = hist + (long long)blockIdx.x * nb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry = 0;
  for (int c0 = 0; c0 < nb; c0 += CHUNK) {
    for (int j = tid; j < CHUNK; j += SR_SCAN_THREADS)
      s_v[j + j / 32] = c0 + j < nb ? a[c0 + j] : 0;
    __syncthreads();
    int v[SR_SCAN_IPT], sum = 0;
#pragma unroll
    for (int q = 0; q < SR_SCAN_IPT; ++q) {
      const int j = tid * SR_SCAN_IPT + q;
      v[q] = s_v[j + j / 32];
      sum += v[q];
    }
    int inc = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(SR_FULL, inc, o);
      if (lane >= o) inc += x;
    }
    if (lane == 31) s_w[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const int w = s_w[lane];
      int wi = w;
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(SR_FULL, wi, o);
        if (lane >= o) wi += x;
      }
      s_w[lane] = wi - w;                       // the warps before
    }
    __syncthreads();
    int at = carry + s_w[warp] + inc - sum;
#pragma unroll
    for (int q = 0; q < SR_SCAN_IPT; ++q) {
      const int j = tid * SR_SCAN_IPT + q;
      s_v[j + j / 32] = at;
      at += v[q];
    }
    __syncthreads();                            // s_w read, s_v written
    for (int j = tid; j < CHUNK; j += SR_SCAN_THREADS)
      if (c0 + j < nb) a[c0 + j] = s_v[j + j / 32];
    if (tid == SR_SCAN_THREADS - 1) s_w[0] = at;   // the carry past the chunk
    __syncthreads();
    carry = s_w[0];
    __syncthreads();                            // before s_v, s_w change
  }
  if (tid == 0) hist[(long long)SR_BINS * nb + blockIdx.x] = carry;
}

// 1c. The stable placement of a block's edges (see the header).  A tile's
// edges are ranked into shared memory in sorted order first, then written
// out in that order, so that each digit's edges go out as one run.
template <bool FIRST>
__global__ void __launch_bounds__(SR_THREADS)
sr_scatter(const int32_t* __restrict__ keys_in,
           const int* __restrict__ vals_in, int* __restrict__ keys_out,
           int* __restrict__ vals_out, const int* __restrict__ hist,
           long long e, int n, int shift, int nb, int sub) {
  __shared__ int s_base[SR_BINS];               // the digit's next position
  __shared__ int s_loc[SR_BINS];                // its start inside the tile
  __shared__ int s_wc[SR_WARPS][SR_BINS];       // per warp: counts, prefixes
  __shared__ int s_key[SR_TILE];                // the tile, sorted by digit
  __shared__ int s_val[SR_TILE];
  __shared__ int s_sum[SR_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  s_base[tid] = block_excl_sum(hist[(long long)SR_BINS * nb + tid], s_sum) +
                hist[(long long)tid * nb + blockIdx.x];
#pragma unroll
  for (int w = 0; w < SR_WARPS; ++w) s_wc[w][tid] = 0;
  __syncthreads();
  const long long lo = (long long)blockIdx.x * sub * SR_TILE;
  const long long hi = min(e, lo + (long long)sub * SR_TILE);
  const unsigned below = (1u << lane) - 1u;
  for (long long t0 = lo; t0 < hi; t0 += SR_TILE) {
    const long long w0 = t0 + (long long)warp * (SR_TILE / SR_WARPS);
    int key[SR_IPT], val[SR_IPT], dig[SR_IPT], rank[SR_IPT];
#pragma unroll
    for (int j = 0; j < SR_IPT; ++j) {
      const long long i = w0 + j * 32 + lane;
      const bool in = i < hi;
      key[j] = in ? key_at<FIRST>(keys_in, i, n) : 0;
      val[j] = FIRST ? (int)i : (in ? vals_in[i] : 0);
      dig[j] = in ? (key[j] >> shift) & (SR_BINS - 1) : -1;
    }
#pragma unroll
    for (int j = 0; j < SR_IPT; ++j) {          // rank inside the warp
      const unsigned peers = same_digit(dig[j], dig[j] >= 0);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (dig[j] >= 0 && lane == leader) {
        base = s_wc[warp][dig[j]];
        s_wc[warp][dig[j]] = base + __popc(peers);
      }
      __syncwarp();
      rank[j] = __shfl_sync(SR_FULL, base, leader < 0 ? 0 : leader) +
                __popc(peers & below);
    }
    __syncthreads();
    int total = 0;                              // digit tid: warps before
#pragma unroll
    for (int w = 0; w < SR_WARPS; ++w) {
      const int c = s_wc[w][tid];
      s_wc[w][tid] = total;
      total += c;
    }
    s_loc[tid] = block_excl_sum(total, s_sum);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SR_IPT; ++j)
      if (dig[j] >= 0) {
        const int at = s_loc[dig[j]] + s_wc[warp][dig[j]] + rank[j];
        s_key[at] = key[j];
        s_val[at] = val[j];
      }
    __syncthreads();
    const int cnt = (int)min((long long)SR_TILE, hi - t0);
    for (int k = tid; k < cnt; k += SR_THREADS) {
      const int kk = s_key[k], dg = (kk >> shift) & (SR_BINS - 1);
      const int pos = s_base[dg] + k - s_loc[dg];
      keys_out[pos] = kk;
      vals_out[pos] = s_val[k];
    }
    __syncthreads();
    s_base[tid] += total;
#pragma unroll
    for (int w = 0; w < SR_WARPS; ++w) s_wc[w][tid] = 0;
    __syncthreads();
  }
}

// 2. start[m] = the first sorted position whose key is >= m, for m in
// [0, n]: position i writes the nodes between its predecessor's key and
// its own, position e those after the last key.  The first edge of a node
// of more than SR_RUN edges (a hub: the key SR_RUN positions on is its
// own) gets SR_HUB in its sorted edge id, for sr_nodes.
__global__ void __launch_bounds__(SR_THREADS)
sr_starts(const int* __restrict__ keys, int* __restrict__ vals,
          int* __restrict__ start, long long e, int n) {
  const long long step = (long long)gridDim.x * SR_THREADS;
  for (long long i = (long long)blockIdx.x * SR_THREADS + threadIdx.x;
       i <= e; i += step) {
    const long long k = i < e ? keys[i] : (long long)n;
    const long long kp = i > 0 ? keys[i - 1] : -1;
    for (long long m = kp + 1; m <= k; ++m) start[m] = (int)i;
    if (k > kp && k < n && i + SR_RUN < e && keys[i + SR_RUN] == k)
      vals[i] |= SR_HUB;
  }
}

// acc += the message rows of sorted positions [p, q), left to right (U
// loads in flight; the adds stay in order).
template <typename T, int VEC>
__device__ __forceinline__ void add_rows(const T* __restrict__ base,
                                         const int* __restrict__ vals,
                                         int p, int q, long long d,
                                         float* acc) {
  using V = typename VecOf<VEC>::type;
  constexpr int VE = VEC / (int)sizeof(T);
  constexpr int U = VEC >= 16 ? 8 : 16;
  for (int i = p; i < q; i += U) {
    Pack<T, VEC> x[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u < q)
        x[u].v = *reinterpret_cast<const V*>(
            base + (long long)(vals[i + u] & ~SR_HUB) * d);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u < q)
#pragma unroll
        for (int c = 0; c < VE; ++c) acc[c] += to_f32(x[u].e[c]);
  }
}

// 3. The hub runs that start in window w (positions [w R, (w + 1) R)):
// at most one of the node at the window's first position (scratch row
// 2 w), and the first run of the node at its last position (row 2 w + 1).
template <typename T, int VEC>
__global__ void __launch_bounds__(SR_THREADS)
sr_runs(const T* __restrict__ msg, const int* __restrict__ keys,
        const int* __restrict__ vals, const int* __restrict__ start,
        float* __restrict__ scratch, int n, int d, int dc, int n_cc, int lr,
        long long windows) {
  constexpr int VE = VEC / (int)sizeof(T);
  const int tid = threadIdx.x;
  const long long w = (long long)blockIdx.x * (SR_THREADS / lr) + tid / lr;
  if (w >= windows) return;
  const int ev = start[n];
  const long long p0 = w * SR_RUN;
  if (p0 >= ev) return;
  const int p1 = (int)min(p0 + SR_RUN, (long long)ev);
  int rp[2], rq[2], slot[2], nr = 0;
  const int a = keys[p0], sa = start[a], ta = start[a + 1];
  if (ta - sa > SR_RUN) {
    const int p = sa + (int)((p0 - sa + SR_RUN - 1) / SR_RUN) * SR_RUN;
    if (p < p1 && p < ta) {
      rp[nr] = p;
      rq[nr] = min(p + SR_RUN, ta);
      slot[nr++] = 0;
    }
  }
  const int b = keys[p1 - 1];
  if (b != a) {
    const int sb = start[b], tb = start[b + 1];
    if (tb - sb > SR_RUN) {
      rp[nr] = sb;
      rq[nr] = sb + SR_RUN;
      slot[nr++] = 1;
    }
  }
  if (nr == 0) return;
  const int col = (tid & (lr - 1)) * VE;
  for (int cc = blockIdx.y; cc < n_cc; cc += gridDim.y) {
    const int c0 = cc * dc;
    if (col >= min(dc, d - c0)) continue;
    for (int r = 0; r < nr; ++r) {
      float acc[VE];
#pragma unroll
      for (int c = 0; c < VE; ++c) acc[c] = 0.f;
      add_rows<T, VEC>(msg + c0 + col, vals, rp[r], rq[r], d, acc);
      float* row = scratch + (2 * w + slot[r]) * d + c0 + col;
#pragma unroll
      for (int c = 0; c < VE; ++c) row[c] = acc[c];
    }
  }
}

// A hub's sum over sorted positions [s, t): its run sums added from
// scratch in run order (run j starts at s + j R in window w = (s + j R) /
// R: row 2 w, but the first run of a node that starts inside a window is
// row 2 w + 1).
template <int VE>
__device__ __forceinline__ void hub_sum(const float* __restrict__ sbase,
                                        int s, int t, long long d,
                                        float* acc) {
  constexpr int U = 4;                          // run sums in flight
#pragma unroll
  for (int c = 0; c < VE; ++c) acc[c] = 0.f;
  for (int p = s; p < t; p += U * SR_RUN) {
    float r[U][VE];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ps = p + u * SR_RUN;
      if (ps < t) {
        const long long row =
            2LL * (ps / SR_RUN) + (ps == s && s % SR_RUN != 0);
#pragma unroll
        for (int c = 0; c < VE; ++c) r[u][c] = sbase[row * d + c];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (p + u * SR_RUN < t)
#pragma unroll
        for (int c = 0; c < VE; ++c) acc[c] += r[u][c];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void put_row(T* __restrict__ out, long long m,
                                        long long d, int col,
                                        const float* acc) {
  using V = typename VecOf<VEC>::type;
  constexpr int VE = VEC / (int)sizeof(T);
  Pack<T, VEC> y;
#pragma unroll
  for (int c = 0; c < VE; ++c) from_f32(y.e[c], acc[c]);
  *reinterpret_cast<V*>(out + m * d + col) = y.v;
}

// One column chunk of a piece: the sorted positions from `first` on,
// U at a time across the nodes (their keys tell where one ends), up to
// the first node that starts at or past p1.  A node of at most SR_RUN
// edges is one run, summed left to right from 0 as its rows arrive; a
// hub (SR_HUB on its first edge) takes its sum from scratch and the walk
// jumps past its edges.
template <typename T, int VEC>
__device__ __forceinline__ void piece_sums(
    const T* __restrict__ base, T* __restrict__ out,
    const int* __restrict__ keys, const int* __restrict__ vals,
    const int* __restrict__ start, const float* __restrict__ sbase,
    int first, int p1, int last, int ev, int n, long long d, int col) {
  using V = typename VecOf<VEC>::type;
  constexpr int VE = VEC / (int)sizeof(T);
  constexpr int U = VEC >= 16 ? 8 : 16;
  float acc[VE];
  int cur = -1, i = first;
  while (true) {
    int kk[U], vv[U];
    Pack<T, VEC> x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = i + u < ev;
      kk[u] = in ? keys[i + u] : n;             // n: past the kept edges
      vv[u] = in ? vals[i + u] : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)                 // this piece's rows only
      if (kk[u] < n && (i + u < p1 || kk[u] == last))
        x[u].v = *reinterpret_cast<const V*>(
            base + (long long)(vv[u] & ~SR_HUB) * d);
    int hub = -1;                               // a hub starts at i + hub
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (hub >= 0) continue;
      if (kk[u] != cur) {                       // a node starts at i + u
        if (cur >= 0) put_row<T, VEC>(out, cur, d, col, acc);
        if (i + u >= p1 || kk[u] >= n) return;  // the next piece's node
        cur = kk[u];
        if (vv[u] & SR_HUB) {
          hub = u;
          continue;
        }
#pragma unroll
        for (int c = 0; c < VE; ++c) acc[c] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < VE; ++c) acc[c] += to_f32(x[u].e[c]);
    }
    int next = i + U;
    if (hub >= 0) {                             // the walk jumps past it
      next = start[cur + 1];
      hub_sum<VE>(sbase, i + hub, next, d, acc);
      put_row<T, VEC>(out, cur, d, col, acc);
      cur = -1;
    }
    i = next;
  }
}

// The same sums node by node, for narrow loads (VEC < 8): a node's rows
// are loaded U at a time within the node only, the next node looked up
// before the current one is summed.
template <typename T, int VEC>
__device__ __forceinline__ void piece_nodes(
    const T* __restrict__ base, T* __restrict__ out,
    const int* __restrict__ keys, const int* __restrict__ vals,
    const int* __restrict__ start, const float* __restrict__ sbase,
    int first, int p1, long long d, int col) {
  constexpr int VE = VEC / (int)sizeof(T);
  int i = first, m = keys[first], t = start[m + 1];
  while (true) {
    int m2 = 0, t2 = 0;                         // the next node, early
    if (t < p1) {
      m2 = keys[t];
      t2 = start[m2 + 1];
    }
    float acc[VE];
#pragma unroll
    for (int c = 0; c < VE; ++c) acc[c] = 0.f;
    if (t - i <= SR_RUN)                        // one run: 0 + run == run
      add_rows<T, VEC>(base, vals, i, t, d, acc);
    else
      hub_sum<VE>(sbase, i, t, d, acc);
    put_row<T, VEC>(out, m, d, col, acc);
    if (t >= p1) break;
    i = t;
    m = m2;
    t = t2;
  }
}

// 4. The sums of the nodes that have edges, one lane group per piece of
// `piece` sorted positions and column chunk: the piece takes the nodes
// whose first edge lies in it, so that each group has about as many edges
// (a node's run stays whole: at most piece + SR_RUN).  Each row is
// written once.
template <typename T, int VEC>
__global__ void __launch_bounds__(SR_THREADS)
sr_nodes(const T* __restrict__ msg, T* __restrict__ out,
         const int* __restrict__ keys, const int* __restrict__ vals,
         const int* __restrict__ start, const float* __restrict__ scratch,
         int n, int d, int dc, int n_cc, int lr, int piece,
         long long pieces) {
  constexpr int VE = VEC / (int)sizeof(T);
  const int tid = threadIdx.x;
  const long long g = (long long)blockIdx.x * (SR_THREADS / lr) + tid / lr;
  if (g >= pieces) return;
  const int ev = start[n];
  const long long p0 = g * piece;
  if (p0 >= ev) return;
  const int p1 = (int)min(p0 + piece, (long long)ev);
  int first = (int)p0;
  if (first > 0 && keys[first - 1] == keys[first])   // begun in a piece before
    first = start[keys[first] + 1];
  if (first >= p1) return;
  const int last = keys[p1 - 1];                // the piece's last node
  const int col = (tid & (lr - 1)) * VE;
  for (int cc = blockIdx.y; cc < n_cc; cc += gridDim.y) {
    const int c0 = cc * dc;
    if (col >= min(dc, d - c0)) continue;
    if (VEC >= 8)
      piece_sums<T, VEC>(msg + c0 + col, out + c0, keys, vals, start,
                         scratch + c0 + col, first, p1, last, ev, n, d, col);
    else
      piece_nodes<T, VEC>(msg + c0 + col, out + c0, keys, vals, start,
                          scratch + c0 + col, first, p1, d, col);
  }
}

// 4b. Zeros for the nodes without edges: a warp takes 32 nodes, finds the
// empty ones by a ballot and writes each one's row with all its lanes.
template <typename T, int VEC>
__global__ void __launch_bounds__(SR_THREADS)
sr_empty(T* __restrict__ out, const int* __restrict__ start, int n, int d) {
  using V = typename VecOf<VEC>::type;
  constexpr int VE = VEC / (int)sizeof(T);
  const int lane = threadIdx.x & 31;
  const long long node0 = ((long long)blockIdx.x * SR_THREADS + threadIdx.x) & ~31LL;
  const long long node = node0 + lane;
  unsigned empty = __ballot_sync(
      SR_FULL, node < n && start[node] == start[node + 1]);
  Pack<T, VEC> y;
#pragma unroll
  for (int c = 0; c < VE; ++c) from_f32(y.e[c], 0.f);
  const int vecs = d / VE;
  while (empty) {
    const int k = __ffs(empty) - 1;
    empty &= empty - 1;
    V* row = reinterpret_cast<V*>(out + (node0 + k) * d);
    for (int c = lane; c < vecs; c += 32) row[c] = y.v;
  }
}

template <typename T, int VEC>
static cudaError_t reduce(const long long* P, const void* msg, void* out,
                          char* ws, const int* keys, const int* vals,
                          cudaStream_t st) {
  const int* start = (const int*)(ws + P[P_WS_START]);
  float* scratch = (float*)(ws + P[P_WS_SCRATCH]);
  const unsigned gy =
      (unsigned)(P[P_N_CC] < 65535 ? P[P_N_CC] : 65535);
  if (P[P_GRID_RUNS] > 0) {
    sr_runs<T, VEC><<<dim3((unsigned)P[P_GRID_RUNS], gy), SR_THREADS, 0,
                      st>>>(
        (const T*)msg, keys, vals, start, scratch, (int)P[P_N], (int)P[P_D],
        (int)P[P_DC], (int)P[P_N_CC], (int)P[P_LR], P[P_WINDOWS]);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  sr_empty<T, VEC><<<(unsigned)P[P_GRID_NODES], SR_THREADS, 0, st>>>(
      (T*)out, start, (int)P[P_N], (int)P[P_D]);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || P[P_E] == 0) return e;
  sr_nodes<T, VEC><<<dim3((unsigned)P[P_GRID_PIECES], gy), SR_THREADS, 0,
                     st>>>(
      (const T*)msg, (T*)out, keys, vals, start, scratch, (int)P[P_N],
      (int)P[P_D], (int)P[P_DC], (int)P[P_N_CC], (int)P[P_LR],
      (int)P[P_PIECE], P[P_PIECES]);
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
  const long long vec = P[P_VEC], dc = P[P_DC], lr = P[P_LR];
  const long long elem = dtype == 0 ? 4 : 2;
  const long long per = SR_THREADS / (lr > 0 ? lr : 1);
  const long long tile_sub = (long long)SR_TILE * (P[P_SUB] > 0 ? P[P_SUB] : 1);
  long long bits = 0;
  while ((n >> bits) > 0) ++bits;                // the keys reach n
  if (e < 0 || e >= (1LL << 31) - SR_RUN || n < 1 || n >= (1LL << 31) - 1 ||
      d < 1 || d >= (1LL << 31) || n * d >= (1LL << 62) || dtype < 0 ||
      dtype > 1 || vec < elem || (d * elem) % vec || ((uintptr_t)msg) % vec ||
      ((uintptr_t)out) % vec || dc < 1 || dc > d || dc % (vec / elem) ||
      lr * (vec / elem) < dc || lr < 1 || lr > 32 || (lr & (lr - 1)) ||
      P[P_N_CC] * dc < d || (P[P_N_CC] - 1) * dc >= d ||
      P[P_RUN] != SR_RUN || P[P_PASSES] * SR_BITS < bits ||
      P[P_PASSES] < 1 || P[P_SUB] < 1 || P[P_NB] * tile_sub < e ||
      P[P_NB] >= (1LL << 31) || P[P_WINDOWS] * SR_RUN < e ||
      P[P_GRID_NODES] * SR_THREADS < n || P[P_GRID_NODES] >= (1LL << 31) ||
      P[P_PIECE] < 1 || P[P_PIECE] > SR_RUN ||
      P[P_PIECES] * P[P_PIECE] < e || P[P_GRID_PIECES] * per < P[P_PIECES] ||
      P[P_GRID_PIECES] >= (1LL << 31) ||
      P[P_GRID_RUNS] * per < P[P_WINDOWS] || P[P_GRID_STARTS] < 1 ||
      P[P_GRID_STARTS] >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  char* w = (char*)ws;
  int* start = (int*)(w + P[P_WS_START]);
  int* key[2] = {(int*)(w + P[P_WS_KEY0]), (int*)(w + P[P_WS_KEY1])};
  int* val[2] = {(int*)(w + P[P_WS_VAL0]), (int*)(w + P[P_WS_VAL1])};
  int* hist = (int*)(w + P[P_WS_HIST]);
  cudaError_t err;
  const int passes = (int)P[P_PASSES];
  const int nb = (int)P[P_NB], sub = (int)P[P_SUB];
  if (e == 0) {
    if ((err = cudaMemsetAsync(start, 0, (size_t)(n + 1) * 4, st)) !=
        cudaSuccess)
      return (int)err;
  } else {
    for (int pass = 0; pass < passes; ++pass) {
      const int shift = pass * SR_BITS;
      const int* kin = pass == 0 ? (const int*)dst : key[(pass - 1) & 1];
      const int* vin = pass == 0 ? nullptr : val[(pass - 1) & 1];
      if (pass == 0)
        sr_hist<true><<<nb, SR_THREADS, 0, st>>>(kin, hist, e, (int)n, shift,
                                                 nb, sub);
      else
        sr_hist<false><<<nb, SR_THREADS, 0, st>>>(kin, hist, e, (int)n,
                                                  shift, nb, sub);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      sr_scan_hist<<<SR_BINS, SR_SCAN_THREADS, 0, st>>>(hist, nb);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      if (pass == 0)
        sr_scatter<true><<<nb, SR_THREADS, 0, st>>>(
            kin, vin, key[0], val[0], hist, e, (int)n, shift, nb, sub);
      else
        sr_scatter<false><<<nb, SR_THREADS, 0, st>>>(
            kin, vin, key[pass & 1], val[pass & 1], hist, e, (int)n, shift,
            nb, sub);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    sr_starts<<<(unsigned)P[P_GRID_STARTS], SR_THREADS, 0, st>>>(
        key[(passes - 1) & 1], val[(passes - 1) & 1], start, e, (int)n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int* keys = key[(passes - 1) & 1];
  const int* vals = val[(passes - 1) & 1];
  if (dtype == 0) {
    switch (vec) {
      case 16: err = reduce<float, 16>(P, msg, out, w, keys, vals, st); break;
      case 8: err = reduce<float, 8>(P, msg, out, w, keys, vals, st); break;
      case 4: err = reduce<float, 4>(P, msg, out, w, keys, vals, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (vec) {
      case 16:
        err = reduce<__nv_bfloat16, 16>(P, msg, out, w, keys, vals, st);
        break;
      case 8:
        err = reduce<__nv_bfloat16, 8>(P, msg, out, w, keys, vals, st);
        break;
      case 4:
        err = reduce<__nv_bfloat16, 4>(P, msg, out, w, keys, vals, st);
        break;
      case 2:
        err = reduce<__nv_bfloat16, 2>(P, msg, out, w, keys, vals, st);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)err;
}
