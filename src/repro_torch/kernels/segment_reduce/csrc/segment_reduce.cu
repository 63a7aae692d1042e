// Segment sum of edge messages into node rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/segment_reduce/kernel.py:
// segment_sum_kernel.  A TPU has no scatter atomics, so that kernel is a
// blocked one-hot matmul on the MXU: for each node tile it walks every edge
// tile and adds onehot(dst == node) @ msg into a VMEM accumulator, which
// costs N/TN passes over the messages.  Its own docstring names the GPU
// form, which is this one: one pass over the messages, each added with an
// atomic into a float32 accumulator, then one cast to the message dtype.
//
//   1. sr_scatter: one warp per edge (grid-stride), lanes over D; edge e
//      adds msg[e, :] into acc[dst[e], :] with atomicAdd (a fire-and-forget
//      RED, the result unused).  dst < 0 and dst >= N are dropped.
//   2. sr_cast: acc (float32) -> out in the message dtype (bfloat16 only;
//      a float32 sum is the accumulator itself).
// The caller zeroes acc.  The sum order of atomics varies from run to run,
// so the float32 sums agree with a sequential sum to rounding only.
//
// What bounds it on an H100: bytes, E x D messages read once (12.2 GB for
// the GIN path's first layer at the ogbn-products shape, bf16, D = 100),
// plus E dst ids and N x D outputs.  The atomics land in L2; on a power-law
// graph a few hub rows take millions of edges each, so their atomics
// serialise.  This simple form pays that contention in full.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define SR_WARPS 8

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(SR_WARPS * 32)
sr_scatter(const int32_t* __restrict__ dst, const T* __restrict__ msg,
           float* __restrict__ acc, long long e_count, int d, int n) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * SR_WARPS;
  for (long long e = blockIdx.x * (long long)SR_WARPS + (threadIdx.x >> 5);
       e < e_count; e += warps) {
    const int node = dst[e];
    if (node < 0 || node >= n) continue;
    const T* row = msg + e * d;
    float* out = acc + (long long)node * d;
    for (int c = lane; c < d; c += 32) atomicAdd(out + c, to_f32(row[c]));
  }
}

__global__ void sr_cast(const float* __restrict__ acc,
                        __nv_bfloat16* __restrict__ out, long long count) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < count; i += stride)
    out[i] = __float2bfloat16(acc[i]);
}

// Plain C entry point, bound with ctypes.  Every pointer is device memory:
// dst int32 [e_count]; msg [e_count, d] of `dtype` (0 = float32,
// 1 = bfloat16); acc float32 [n, d], zeroed by the caller; out [n, d]
// bfloat16 when dtype is 1 (unused, may be null, for float32: acc is the
// result).  Returns cudaGetLastError() after the launches (0 = ok).
extern "C" int segment_sum_launch(const void* dst, const void* msg,
                                  void* acc, void* out, long long e_count,
                                  int d, int n, int dtype, void* stream) {
  if (e_count < 0 || d < 1 || n < 1 || dtype < 0 || dtype > 1 ||
      (dtype == 1 && out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  long long blocks = (e_count + SR_WARPS - 1) / SR_WARPS;
  if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond this
  if (blocks > 0) {
    if (dtype == 0)
      sr_scatter<float><<<(unsigned)blocks, SR_WARPS * 32, 0, st>>>(
          (const int32_t*)dst, (const float*)msg, (float*)acc, e_count, d, n);
    else
      sr_scatter<__nv_bfloat16><<<(unsigned)blocks, SR_WARPS * 32, 0, st>>>(
          (const int32_t*)dst, (const __nv_bfloat16*)msg, (float*)acc,
          e_count, d, n);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (dtype == 1) {
    const long long count = (long long)n * d;
    long long cblocks = (count + 255) / 256;
    if (cblocks > 132LL * 32) cblocks = 132LL * 32;
    sr_cast<<<(unsigned)cblocks, 256, 0, st>>>(
        (const float*)acc, (__nv_bfloat16*)out, count);
  }
  return (int)cudaGetLastError();
}
