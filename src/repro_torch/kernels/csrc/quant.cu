// Int8 wire codec for Hopper (sm_90a): per-chunk absmax quantize and
// dequantize-accumulate, with a plain C interface that kernels/quant.py loads
// through ctypes.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/quant.py:
//  * _quant_int8_kernel (behind wire_quantize_pallas): for each row of
//    x (nchunks, chunk) f32, absmax = max |x| (a NaN anywhere makes it NaN,
//    as jnp.max does), scale = absmax * (1/127) where absmax > 0 and 1
//    otherwise (so a zero chunk and a NaN chunk both store 1), and
//    codes = clip(round_half_even(x / scale), -127, 127) as int8, a NaN code
//    becoming 0 as XLA's float-to-int8 convert makes it;
//  * _dq_accum_kernel (behind wire_dequant_accum_pallas):
//    out = acc + float(codes) * scale[row], f32.
// Both must equal their plain torch versions bit for bit, which fixes the
// arithmetic.  The scale is absmax times the f32 reciprocal of 127, as the
// jitted JAX reference computes it (XLA rewrites a division by a constant into
// a multiply by its reciprocal; the codes then match the reference bit for
// bit).  x / scale is an IEEE division (__fdiv_rn, never a multiply by a
// reciprocal; the build has no --use_fast_math).  The rounding is rintf (half
// to even, where roundf would round halves away from zero).  The decode is a
// product and a sum each rounded on its own (__fmul_rn, __fadd_rn), because
// nvcc would otherwise contract them into one FMA with a single rounding (XLA
// on the CPU does fuse them: the reference's decode lies within one ulp).
//
// What bounds it on an H100: both are streams with a few operations per
// element (quantize reads 4 bytes and writes 1 per element, dequantize reads 5
// and writes 4), so device memory, 3.35 TB/s.  The training step launches
// them at rows from 1 to 55296 (DESIGN_TORCH.md §15): the largest moves 142
// and 255 MB, the smallest only a launch.
//
// The fast path is the port's only chunk width, 512 (quant.DEFAULT_CHUNK),
// with 16-byte aligned rows: one warp per row, eight rows a block, a grid of
// one block per eight rows (the last rows past the end return at once).  Lane
// l holds the float4 vectors l, l + 32, l + 64 and l + 96 of its row, so each
// warp-wide load reads 512 contiguous bytes; it issues all four loads (and the
// decode its four char4 code loads) before it uses any, so a row costs one
// memory latency, and the quantize keeps its row in registers between the
// absmax and the encode (no second read).  The scale is loaded once per row
// and no index is divided.  Every other width or alignment takes the generic
// kernels below: a warp per row with vectors where the width and pointers
// allow them, else scalars, and a grid-stride decode.  DESIGN_TORCH.md §15
// lists the variants timed against this one (a lane owning 16 contiguous
// elements, two rows a warp, evict-first loads).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;      // one warp per chunk row
constexpr int kThreads = kRowsPerBlock * 32;
constexpr int kChunk = 512;           // the fast path's width
constexpr int kVecs = kChunk / 128;   // float4 per lane per row
constexpr float kTop = 127.f;
constexpr float kInvTop = 1.f / 127.f;  // rounded to f32 at compile time

// The jnp.max rule: a NaN on either side wins.
__device__ __forceinline__ float nan_max(float m, float a) {
  return (a > m || a != a) ? a : m;
}

__device__ __forceinline__ float warp_absmax(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

__device__ __forceinline__ float row_scale(float absmax) {
  return absmax > 0.f ? __fmul_rn(absmax, kInvTop) : 1.f;
}

__device__ __forceinline__ signed char encode(float x, float scale) {
  float q = rintf(__fdiv_rn(x, scale));
  if (q != q) return 0;
  q = fminf(fmaxf(q, -kTop), kTop);
  return static_cast<signed char>(static_cast<int>(q));
}

__device__ __forceinline__ float decode_add(float acc, signed char c, float s) {
  return __fadd_rn(acc, __fmul_rn(static_cast<float>(c), s));
}

__global__ void __launch_bounds__(kThreads)
    quant512_kernel(const float* __restrict__ x, signed char* __restrict__ codes,
                    float* __restrict__ scales, long long rows) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;          // the whole warp: its row is past the end
  const float4* xr = reinterpret_cast<const float4*>(x + row * kChunk) + lane;
  float4 v[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) v[i] = xr[32 * i];
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    m = nan_max(m, fabsf(v[i].x));
    m = nan_max(m, fabsf(v[i].y));
    m = nan_max(m, fabsf(v[i].z));
    m = nan_max(m, fabsf(v[i].w));
  }
  const float scale = row_scale(warp_absmax(m));
  if (lane == 0) scales[row] = scale;
  char4* cr = reinterpret_cast<char4*>(codes + row * kChunk) + lane;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    char4 c;
    c.x = encode(v[i].x, scale);
    c.y = encode(v[i].y, scale);
    c.z = encode(v[i].z, scale);
    c.w = encode(v[i].w, scale);
    cr[32 * i] = c;
  }
}

__global__ void __launch_bounds__(kThreads)
    dq512_kernel(const float* __restrict__ acc, const signed char* __restrict__ codes,
                 const float* __restrict__ scales, float* __restrict__ out, long long rows) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const float4* ar = reinterpret_cast<const float4*>(acc + row * kChunk) + lane;
  const char4* cr = reinterpret_cast<const char4*>(codes + row * kChunk) + lane;
  const float s = scales[row];
  float4 a[kVecs];
  char4 c[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) a[i] = ar[32 * i];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) c[i] = cr[32 * i];
  float4* orow = reinterpret_cast<float4*>(out + row * kChunk) + lane;
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
    orow[32 * i] = make_float4(decode_add(a[i].x, c[i].x, s), decode_add(a[i].y, c[i].y, s),
                               decode_add(a[i].z, c[i].z, s), decode_add(a[i].w, c[i].w, s));
}

// Generic widths and alignments: a warp per row, 16-byte vectors where the
// width is a multiple of 4 and x is aligned (vec), else scalars.
__global__ void __launch_bounds__(kThreads)
    quant_any_kernel(const float* __restrict__ x, signed char* __restrict__ codes,
                     float* __restrict__ scales, long long rows, int chunk, int vec) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const float* xr = x + row * chunk;
  signed char* cr = codes + row * chunk;
  float m = 0.f;
  if (vec) {
    for (int i = 4 * lane; i < chunk; i += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xr + i);
      m = nan_max(m, fabsf(v.x));
      m = nan_max(m, fabsf(v.y));
      m = nan_max(m, fabsf(v.z));
      m = nan_max(m, fabsf(v.w));
    }
  } else {
    for (int i = lane; i < chunk; i += 32) m = nan_max(m, fabsf(xr[i]));
  }
  const float scale = row_scale(warp_absmax(m));
  if (lane == 0) scales[row] = scale;
  if (vec) {
    for (int i = 4 * lane; i < chunk; i += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xr + i);
      char4 c;
      c.x = encode(v.x, scale);
      c.y = encode(v.y, scale);
      c.z = encode(v.z, scale);
      c.w = encode(v.w, scale);
      *reinterpret_cast<char4*>(cr + i) = c;
    }
  } else {
    for (int i = lane; i < chunk; i += 32) cr[i] = encode(xr[i], scale);
  }
}

// Generic decode: a grid-stride loop over 4-element vectors (the four share a
// row when the width is a multiple of 4) or over elements.
__global__ void __launch_bounds__(kThreads)
    dq_any_kernel(const float* __restrict__ acc, const signed char* __restrict__ codes,
                  const float* __restrict__ scales, float* __restrict__ out,
                  long long n, int chunk, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    for (long long i = tid; i < n / 4; i += stride) {
      const float s = scales[4 * i / chunk];
      const float4 a = reinterpret_cast<const float4*>(acc)[i];
      const char4 c = reinterpret_cast<const char4*>(codes)[i];
      reinterpret_cast<float4*>(out)[i] =
          make_float4(decode_add(a.x, c.x, s), decode_add(a.y, c.y, s),
                      decode_add(a.z, c.z, s), decode_add(a.w, c.w, s));
    }
  } else {
    for (long long i = tid; i < n; i += stride)
      out[i] = decode_add(acc[i], codes[i], scales[i / chunk]);
  }
}

int g_blocks = 0;

int max_blocks() {
  if (g_blocks == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    g_blocks = sms * 2048 / kThreads;
  }
  return g_blocks;
}

bool aligned(const void* p, int bytes) { return (uintptr_t)p % bytes == 0; }

}  // namespace

extern "C" {

// x (rows, chunk) f32 -> codes (rows, chunk) int8, scales (rows,) f32, all
// contiguous.  Returns a cudaError_t (0: launched); nothing is synchronised.
int quant_int8(const float* x, signed char* codes, float* scales, long long rows,
               int chunk, void* stream) {
  if (rows <= 0 || chunk <= 0) return 0;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk == kChunk && aligned(x, 16) && aligned(codes, 4)) {
    quant512_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(x, codes, scales, rows);
  } else {
    const int vec = chunk % 4 == 0 && aligned(x, 16) && aligned(codes, 4);
    quant_any_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(x, codes, scales, rows, chunk, vec);
  }
  return (int)cudaGetLastError();
}

// out = acc + float(codes) * scales[row] over (rows, chunk), contiguous.
int dq_accum_int8(const float* acc, const signed char* codes, const float* scales,
                  float* out, long long rows, int chunk, void* stream) {
  const long long n = rows * chunk;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk == kChunk && aligned(acc, 16) && aligned(out, 16) && aligned(codes, 4)) {
    const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    dq512_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(acc, codes, scales, out, rows);
    return (int)cudaGetLastError();
  }
  const int vec = chunk % 4 == 0 && aligned(acc, 16) && aligned(out, 16) && aligned(codes, 4);
  const long long want = (n / (vec ? 4 : 1) + kThreads - 1) / kThreads;
  const int cap = max_blocks();
  const int blocks = (int)(want < cap ? (want > 0 ? want : 1) : cap);
  dq_any_kernel<<<blocks, kThreads, 0, s>>>(acc, codes, scales, out, n, chunk, vec);
  return (int)cudaGetLastError();
}

const char* quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
