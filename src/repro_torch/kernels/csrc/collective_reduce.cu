// Collective reduce for Hopper (sm_90a): out = acc + float(incoming), with a
// plain C interface that kernels/collective_reduce.py loads through ctypes.
//
// Replaces src/repro/kernels/collective_reduce.py::_reduce_kernel, the Pallas
// TPU kernel behind repro.kernels.ops.collective_reduce: the chunk accumulate
// of a ring reduce-scatter step, fused with the wire's dtype decompression
// (acc in f32, incoming in f32 or bf16).  Same function; the layout differs:
// the TPU wrapper reshapes a flat chunk to (M, 256) and pads ragged shapes to
// its block grid, here the kernel walks the flat chunk and masks its own
// tail, so no padding copy is made.
//
// What bounds it on an H100: three streams and no arithmetic to speak of (one
// add per 8 or 10 bytes moved), so device memory, 3.35 TB/s.  The design
// reads each input once and writes the output once: a grid-stride loop of
// 16-byte vectors where the pointers allow it, scalar elements for the tail.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Four elements of incoming as floats, from one aligned vector load.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&raw.x);
  __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&raw.y);
  float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename In>
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* __restrict__ acc, const In* __restrict__ inc,
                  float* __restrict__ out, long long n, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      float4 a = reinterpret_cast<const float4*>(acc)[i];
      float4 b = load4(inc + 4 * i);
      reinterpret_cast<float4*>(out)[i] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride) out[i] = acc[i] + to_float(inc[i]);
}

int g_blocks = 0;

}  // namespace

extern "C" {

// inc_dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t (0: launched).
int collective_reduce(const float* acc, const void* inc, int inc_dtype, float* out,
                      long long n, void* stream) {
  if (n <= 0) return 0;
  if (g_blocks == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    g_blocks = sms * 2048 / kThreads;
  }
  const size_t in_bytes = inc_dtype == 1 ? 8 : 16;   // four elements of incoming
  const int vec = ((uintptr_t)acc % 16 == 0) && ((uintptr_t)out % 16 == 0) &&
                  ((uintptr_t)inc % in_bytes == 0);
  long long want = (n / (vec ? 4 : 1) + kThreads - 1) / kThreads;
  const int blocks = (int)(want < g_blocks ? (want > 0 ? want : 1) : g_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (inc_dtype == 0)
    reduce_kernel<float><<<blocks, kThreads, 0, s>>>(acc, static_cast<const float*>(inc), out, n, vec);
  else if (inc_dtype == 1)
    reduce_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        acc, static_cast<const __nv_bfloat16*>(inc), out, n, vec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* collective_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
