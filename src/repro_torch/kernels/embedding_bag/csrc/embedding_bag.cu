// Sum-mode EmbeddingBag for Hopper (sm_90a), in one launch.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/kernel.py:
// embedding_bag_kernel.  There, a grid of one step per flat id DMAs the one
// table row that a scalar-prefetched id picks, and accumulates it into the
// output row of its bag, which stays in VMEM while consecutive steps revisit
// it (ids sorted by bag).  Hopper blocks run in no order, so nothing carries
// from one id to the next; each bag is one lane group's work instead, and
// each block finds its own bags' ids:
//
//   1. A block owns `bags_per_block` consecutive bags [b0, b1).  Warp 0
//      finds L = lower_bound(bags, b0) and warp 1 H = lower_bound(bags, b1)
//      with a 32-ary search: each lane probes one of 32 evenly spaced
//      positions and __ballot_sync narrows the range 32x per step (5 steps
//      for the 4.2 M ids of Wide&Deep's serve_bulk).
//   2. The block reads bags[L, H) once, coalesced: position p starts every
//      bag b with bags[p-1] < b <= bags[p], so it writes start[b - b0] = p
//      into shared memory (bags with no id keep start = H).
//   3. A group of `gw` lanes sums each bag in float32 and writes its row
//      once in the table's dtype.  Inside a group, `lr` lanes cover one
//      table row with VEC-byte loads and the group's gw / lr row slots take
//      different ids; a shuffle reduce adds the slots.  At D = 1 (the wide
//      side) gw is 8 or 16, so several bags share a warp; at D > 1 a bag
//      has the whole warp.  A group sums `k_bags` bags one after the
//      other (bags g, g + groups, ...), so that at large batches the two
//      searches of step 1 are shared by more bags.
//
// Ids of -1 add nothing.  Unlike the TPU kernel, which zeroes an output row
// only on its bag's first id, a bag with no ids is written as zeros (the
// plain version's contract).  Ids outside [0, V) and bags outside
// [0, n_bags) are skipped, never read out of bounds.  `bags` must be sorted
// ascending; the kernel does not check it (unsorted input gives some sum of
// in-range rows, with every read in bounds).
//
// What bounds it on an H100: bytes.  Each id costs 8 bytes of ids/bags plus
// one table row gathered from a random place (at D == 1 one 32-byte sector
// for 4 useful bytes); the output is n_bags x D.  No arithmetic to speak of.
// At small batches (512 bags) the launch and the host wrapper are the cost,
// hence one launch and no scratch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define EB_THREADS 256
#define EB_MAX_K 8          // bags per lane group
#define EB_MAX_BAGS (EB_THREADS / 8 * EB_MAX_K)   // bags per block
#define EB_FULL 0xffffffffu

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

// First position in [lo, hi) whose bag is >= key (hi if none), found by the
// whole warp; lo and hi are the same in every lane.
__device__ __forceinline__ int warp_lower_bound(const int32_t* __restrict__ bags,
                                                int lo, int hi, int key,
                                                int lane) {
  while (lo < hi) {                            // the answer lies in [lo, hi]
    const int s = (hi - lo + 31) / 32;         // probe spacing
    const long long p = lo + (long long)(lane + 1) * s - 1;
    const bool below = p < hi && bags[p] < key;
    const int k = __popc(__ballot_sync(EB_FULL, below));
    const long long nhi = lo + (long long)(k + 1) * s - 1;
    lo += k * s;
    hi = nhi < hi ? (int)nhi : hi;
  }
  return lo;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(EB_THREADS)
eb_bag_sum(const int32_t* __restrict__ ids, const int32_t* __restrict__ bags,
           const T* __restrict__ table, T* __restrict__ out, int t,
           int n_bags, long long v, int d, int gw, int lr, int k_bags) {
  constexpr int VE = VEC / (int)sizeof(T);
  __shared__ int s_bounds[2];
  __shared__ int s_start[EB_MAX_BAGS + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = EB_THREADS / gw, per_block = groups * k_bags;
  const long long b0 = (long long)blockIdx.x * per_block;
  const int nb = (int)(n_bags - b0 < per_block ? n_bags - b0 : per_block);

  if (warp < 2)
    s_bounds[warp] = warp_lower_bound(bags, 0, t, (int)(b0 + warp * nb),
                                      lane);
  __syncthreads();
  const int lo_all = s_bounds[0];
  const int hi_all = s_bounds[1] > lo_all ? s_bounds[1] : lo_all;
  for (int k = tid; k <= nb; k += EB_THREADS) s_start[k] = hi_all;
  __syncthreads();
  for (int p = lo_all + tid; p < hi_all; p += EB_THREADS) {
    const long long cur = bags[p];
    const long long prev = p == lo_all ? b0 - 1 : (long long)bags[p - 1];
    const long long first = prev + 1 > b0 ? prev + 1 : b0;
    const long long last = cur < b0 + nb - 1 ? cur : b0 + nb - 1;
    for (long long b = first; b <= last; ++b) s_start[b - b0] = p;
  }
  __syncthreads();

  const int gl = tid & (gw - 1);                  // lane in its group
  const unsigned gmask =
      gw == 32 ? EB_FULL : ((1u << gw) - 1u) << (lane & ~(gw - 1));
  const int slot = gl / lr, slots = gw / lr, col = (gl & (lr - 1)) * VE;
  // group g sums bags g, g + groups, ...; whole groups leave together
  for (int k = tid / gw; k < nb; k += groups) {
    const int lo = s_start[k];
    const int hi = s_start[k + 1] > lo ? s_start[k + 1] : lo;
    T* row_out = out + (b0 + k) * d;
    for (int base = 0; base < d; base += lr * VE) {
      const int c = base + col;
      float acc[VE];
#pragma unroll
      for (int q = 0; q < VE; ++q) acc[q] = 0.f;
      if (c < d) {
#pragma unroll 4
        for (int i = lo + slot; i < hi; i += slots) {
          const int id = ids[i];
          if (id < 0 || id >= v) continue;
          Pack<T, VEC> x;
          x.v = *reinterpret_cast<const typename VecOf<VEC>::type*>(
              table + (long long)id * d + c);
#pragma unroll
          for (int q = 0; q < VE; ++q) acc[q] += to_f32(x.e[q]);
        }
      }
      for (int off = lr; off < gw; off <<= 1)
#pragma unroll
        for (int q = 0; q < VE; ++q)
          acc[q] += __shfl_xor_sync(gmask, acc[q], off);
      if (slot == 0 && c < d) {
        Pack<T, VEC> y;
#pragma unroll
        for (int q = 0; q < VE; ++q) from_f32(y.e[q], acc[q]);
        *reinterpret_cast<typename VecOf<VEC>::type*>(row_out + c) = y.v;
      }
    }
  }
}

template <typename T, int VEC>
static int launch(const void* ids, const void* bags, const void* table,
                  void* out, int t, int n_bags, long long v, int d, int gw,
                  int lr, int k_bags, long long blocks, cudaStream_t st) {
  eb_bag_sum<T, VEC><<<(unsigned)blocks, EB_THREADS, 0, st>>>(
      (const int32_t*)ids, (const int32_t*)bags, (const T*)table, (T*)out, t,
      n_bags, v, d, gw, lr, k_bags);
  return (int)cudaGetLastError();
}

// The launch plan, an int64 array in this order (kernel.py PLAN_FIELDS).
enum {
  E_T, E_N_BAGS, E_V, E_D, E_DTYPE, E_VEC, E_GW, E_LR, E_K_BAGS, E_BLOCKS,
  E_COUNT
};

// Plain C entry point, bound with ctypes.  Every pointer but `plan` is
// device memory: ids, bags int32 [t]; table [v, d] and out [n_bags, d] of
// the plan's dtype (0 = float32, 1 = bfloat16).  `plan` (host memory,
// E_COUNT int64 values) is kernel.py's plan(): `vec` bytes per load, `gw`
// lanes per bag, `lr` lanes per table row, `k_bags` bags per lane group,
// `blocks`; the table's base pointer and row bytes must be multiples of
// `vec`.  Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int embedding_bag_launch(const void* ids, const void* bags,
                                    const void* table, void* out,
                                    const long long* plan, int n_fields,
                                    void* stream) {
  if (n_fields != E_COUNT) return (int)cudaErrorInvalidValue;
  const long long t = plan[E_T], n_bags = plan[E_N_BAGS], v = plan[E_V];
  const long long d = plan[E_D], dtype = plan[E_DTYPE], vec = plan[E_VEC];
  const long long gw = plan[E_GW], lr = plan[E_LR], k_bags = plan[E_K_BAGS];
  const long long blocks = plan[E_BLOCKS];
  const long long elem = dtype == 0 ? 4 : 2;
  if (t < 0 || t >= (1LL << 31) || n_bags < 1 || n_bags >= (1LL << 31) - 1 ||
      v < 1 || d < 1 || d >= (1LL << 31) || dtype < 0 || dtype > 1 ||
      (gw != 8 && gw != 16 && gw != 32) || lr < 1 || lr > gw ||
      (lr & (lr - 1)) || vec < elem || (d * elem) % vec ||
      ((uintptr_t)table) % vec || k_bags < 1 || k_bags > EB_MAX_K ||
      blocks < 1 || blocks * (EB_THREADS / gw) * k_bags < n_bags)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define EB_LAUNCH(T, V)                                                    \
  return launch<T, V>(ids, bags, table, out, (int)t, (int)n_bags, v,       \
                      (int)d, (int)gw, (int)lr, (int)k_bags, blocks, st)
  if (dtype == 0) {
    switch (vec) {
      case 16: EB_LAUNCH(float, 16);
      case 8: EB_LAUNCH(float, 8);
      case 4: EB_LAUNCH(float, 4);
    }
  } else {
    switch (vec) {
      case 16: EB_LAUNCH(__nv_bfloat16, 16);
      case 8: EB_LAUNCH(__nv_bfloat16, 8);
      case 4: EB_LAUNCH(__nv_bfloat16, 4);
      case 2: EB_LAUNCH(__nv_bfloat16, 2);
    }
  }
#undef EB_LAUNCH
  return (int)cudaErrorInvalidValue;
}
