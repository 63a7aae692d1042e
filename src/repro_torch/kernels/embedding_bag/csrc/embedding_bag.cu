// Sum-mode EmbeddingBag for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/kernel.py:
// embedding_bag_kernel.  There, a grid of one step per flat id DMAs the one
// table row that a scalar-prefetched id picks, and accumulates it into the
// output row of its bag, which stays in VMEM while consecutive steps revisit
// it (ids sorted by bag).  Hopper blocks run in no order, so nothing carries
// from one id to the next; each bag is one warp's work instead:
//
//   1. eb_starts: bags is sorted ascending, so start[b] = #{i : bags[i] < b}
//      for b in [0, n_bags] is found without a search: position i writes
//      start[b] = i for every b with bags[i-1] < b <= bags[i].  Each b is
//      written exactly once, in O(T + n_bags) work.
//   2. eb_sum: one warp per bag over ids[start[b] .. start[b+1]), float32
//      accumulation, one store per output element in the table's dtype.
//      D == 1 (the Wide&Deep wide side): lanes over the bag's ids, then a
//      warp reduce.  D > 1: the warp loads 32 ids at a time and walks them;
//      lanes over D read each table row coalesced.
//
// Ids of -1 add nothing.  Unlike the TPU kernel, which zeroes an output row
// only on its bag's first id, a bag with no ids is written as zeros (the
// plain version's contract).  Ids outside [0, V) and bags outside
// [0, n_bags) are skipped, never read out of bounds.  `bags` must be sorted
// ascending; the kernel does not check it.
//
// What bounds it on an H100: bytes.  Each id costs 8 bytes of ids/bags plus
// one table row gathered from a random place (at D == 1 one 32-byte sector
// for 4 useful bytes); the output is n_bags x D.  No arithmetic to speak of.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define EB_WARPS 8
#define EB_FULL 0xffffffffu

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__global__ void eb_starts(const int32_t* __restrict__ bags,
                          int32_t* __restrict__ start, long long t,
                          int n_bags) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i > t) return;
  const long long lo = i == 0 ? -1 : (long long)bags[i - 1];   // exclusive
  const long long hi = i == t ? (long long)n_bags : (long long)bags[i];
  const long long first = lo + 1 > 0 ? lo + 1 : 0;
  const long long last = hi < n_bags ? hi : (long long)n_bags;
  for (long long b = first; b <= last; ++b) start[b] = (int32_t)i;
}

template <typename T>
__global__ void __launch_bounds__(EB_WARPS * 32)
eb_sum(const int32_t* __restrict__ ids, const int32_t* __restrict__ start,
       const T* __restrict__ table, T* __restrict__ out, int n_bags,
       long long v, int d) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * EB_WARPS;
  for (long long b = blockIdx.x * (long long)EB_WARPS + (threadIdx.x >> 5);
       b < n_bags; b += warps) {
    const int lo = start[b], hi = start[b + 1];
    if (d == 1) {
      float acc = 0.f;
      for (int i = lo + lane; i < hi; i += 32) {
        const int id = ids[i];
        if (id >= 0 && id < v) acc += to_f32(table[id]);
      }
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(EB_FULL, acc, off);
      if (lane == 0) store(out + b, acc);
      continue;
    }
    for (int c = 0; c < d; c += 32) {
      const int col = c + lane;
      float acc = 0.f;
      for (int i0 = lo; i0 < hi; i0 += 32) {
        const int mine = i0 + lane < hi ? ids[i0 + lane] : -1;
        const int n = min(32, hi - i0);
        for (int k = 0; k < n; ++k) {
          const int id = __shfl_sync(EB_FULL, mine, k);
          if (id >= 0 && id < v && col < d)
            acc += to_f32(table[(long long)id * d + col]);
        }
      }
      if (col < d) store(out + b * d + col, acc);
    }
  }
}

// Plain C entry point, bound with ctypes.  Every pointer is device memory:
// ids, bags int32 [t]; start int32 [n_bags + 1] scratch; table [v, d] and out
// [n_bags, d] of the dtype given by `dtype` (0 = float32, 1 = bfloat16).
// Returns cudaGetLastError() after the launches (0 = ok).
extern "C" int embedding_bag_launch(const void* ids, const void* bags,
                                    const void* table, void* start,
                                    void* out, long long t, int n_bags,
                                    long long v, int d, int dtype,
                                    void* stream) {
  if (t < 0 || n_bags < 1 || v < 1 || d < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_pos = t + 1;
  eb_starts<<<(unsigned)((n_pos + 255) / 256), 256, 0, st>>>(
      (const int32_t*)bags, (int32_t*)start, t, n_bags);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  long long blocks = ((long long)n_bags + EB_WARPS - 1) / EB_WARPS;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  if (dtype == 0)
    eb_sum<float><<<(unsigned)blocks, EB_WARPS * 32, 0, st>>>(
        (const int32_t*)ids, (const int32_t*)start, (const float*)table,
        (float*)out, n_bags, v, d);
  else
    eb_sum<__nv_bfloat16><<<(unsigned)blocks, EB_WARPS * 32, 0, st>>>(
        (const int32_t*)ids, (const int32_t*)start,
        (const __nv_bfloat16*)table, (__nv_bfloat16*)out, n_bags, v, d);
  return (int)cudaGetLastError();
}
