// Collective reduce for Hopper (sm_90a): out = acc + float(incoming), with a
// plain C interface that kernels/collective_reduce.py loads through ctypes.
//
// Replaces src/repro/kernels/collective_reduce.py::_reduce_kernel, the Pallas
// TPU kernel behind repro.kernels.ops.collective_reduce: the chunk accumulate
// of a ring reduce-scatter step, fused with the wire's dtype decompression
// (acc in f32, incoming in f32 or bf16).  Same function; the layout differs:
// the TPU wrapper reshapes a flat chunk to (M, 256) and pads ragged shapes to
// its block grid, here the kernel walks the flat chunk and masks its own
// tail, so no padding copy is made.  Each element is one f32 add, so the
// result equals the plain version bit for bit.
//
// What bounds it on an H100: three streams and no arithmetic to speak of (one
// add per 8 or 10 bytes moved), so device memory, 3.35 TB/s.  Each input is
// read once and the output written once:
//  * aligned pointers (acc and out 16-byte aligned, incoming aligned to four
//    of its elements): reduce_vectors, a persistent grid (SMs x
//    kVecBlocksPerSM), each block one contiguous span of whole tiles of
//    kThreads x kUnroll vectors of 4 elements (16 bytes of acc and out; of
//    incoming 16 bytes of f32, 8 of bf16); every thread issues its kUnroll
//    loads of each input before its first store, with streaming cache hints
//    (ld.global.nc.L1::no_allocate, st.global.cs).  A warp's loads and
//    stores each cover contiguous bytes: 16-byte loads of 8 bf16, beside two
//    of acc each half a 32-byte sector apart, ran 36% slower at bf16.  The
//    scalar tail (fewer elements than a vector) goes to the last block.
//  * any other pointers: reduce_kernel, a grid-stride loop of scalar
//    elements over 8 blocks per SM.
// The grid-stride loop of 16-byte vectors this replaced, and a design of
// cp.async.bulk copies through shared memory, were slower than
// reduce_vectors at f32 and at bf16 incoming (DESIGN_TORCH.md section 18).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// ---------------------------------------------------------------------------
// the unaligned route: scalar elements, grid-stride
// ---------------------------------------------------------------------------

template <typename In>
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* __restrict__ acc, const In* __restrict__ inc,
                  float* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = acc[i] + to_float(inc[i]);
}

// ---------------------------------------------------------------------------
// vectors: persistent spans, kUnroll loads of each input in flight a thread
// ---------------------------------------------------------------------------

constexpr int kUnroll = 4;
constexpr int kVecBlocksPerSM = 4;

__device__ __forceinline__ float4 ld_stream_f4(const void* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// Four elements of incoming as floats, read once: 16 bytes of f32, 8 of bf16.
__device__ __forceinline__ float4 ld_stream4(const float* p) { return ld_stream_f4(p); }
__device__ __forceinline__ float4 ld_stream4(const __nv_bfloat16* p) {
  uint32_t lo, hi;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(lo), "=r"(hi)
               : "l"(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void st_stream_f4(void* p, float4 v) {
  asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

// Block b takes tiles [b T / B, (b + 1) T / B) of the T tiles of kThreads x
// kUnroll vectors of 4 elements (the last tile cut at the last whole
// vector); thread i of a tile takes its vectors i, i + kThreads, ..., so
// each load and store of a warp covers 512 contiguous bytes of acc and out
// (256 of bf16 incoming).
template <typename In>
__global__ void __launch_bounds__(kThreads)
    reduce_vectors(const float* __restrict__ acc, const In* __restrict__ inc,
                   float* __restrict__ out, long long n) {
  const long long nv = n / 4;
  const long long tile = (long long)kThreads * kUnroll;
  const long long n_tiles = (nv + tile - 1) / tile;
  const long long t0 = blockIdx.x * n_tiles / gridDim.x;
  const long long t1 = (blockIdx.x + 1) * n_tiles / gridDim.x;
  for (long long t = t0; t < t1; ++t) {
    const long long v0 = t * tile + threadIdx.x;
    float4 a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * kThreads;
      if (v < nv) {
        a[u] = ld_stream_f4(acc + 4 * v);
        b[u] = ld_stream4(inc + 4 * v);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * kThreads;
      if (v < nv) st_stream_f4(out + 4 * v, add4(a[u], b[u]));
    }
  }
  if (blockIdx.x == gridDim.x - 1)
    for (long long i = nv * 4 + threadIdx.x; i < n; i += kThreads)
      out[i] = acc[i] + to_float(inc[i]);
}

int g_sms = 0;

template <typename In>
int launch(const float* acc, const In* inc, float* out, long long n, cudaStream_t s) {
  const bool vec = ((uintptr_t)acc % 16 == 0) && ((uintptr_t)out % 16 == 0) &&
                   ((uintptr_t)inc % (4 * sizeof(In)) == 0);
  if (vec) {
    const long long tiles = (n / 4 + kThreads * kUnroll - 1) / (kThreads * kUnroll);
    const long long most = (long long)g_sms * kVecBlocksPerSM;
    const int blocks = (int)(tiles < 1 ? 1 : tiles < most ? tiles : most);
    reduce_vectors<In><<<blocks, kThreads, 0, s>>>(acc, inc, out, n);
  } else {
    const long long most = (long long)g_sms * 2048 / kThreads;
    const long long want = (n + kThreads - 1) / kThreads;
    reduce_kernel<In><<<(int)(want < most ? want : most), kThreads, 0, s>>>(acc, inc, out, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// inc_dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t (0: launched).
int collective_reduce(const float* acc, const void* inc, int inc_dtype, float* out,
                      long long n, void* stream) {
  if (n <= 0) return 0;
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (inc_dtype == 0) return launch(acc, static_cast<const float*>(inc), out, n, s);
  if (inc_dtype == 1)
    return launch(acc, static_cast<const __nv_bfloat16*>(inc), out, n, s);
  return (int)cudaErrorInvalidValue;
}

const char* collective_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
