// Grouped (per-expert) matmul for Hopper (sm_90a), with a plain C interface
// that kernels/grouped_matmul.py loads through ctypes.
//
// Replaces src/repro/kernels/grouped_matmul.py::_gmm_kernel, the Pallas TPU
// kernel behind repro.kernels.ops.grouped_matmul and expert_ffn_pallas.  Same
// function: out[g] = x[g] @ w[g] for x (G, M, K) and w (G, K, N), an f32
// accumulator, the result rounded once to x's type.  The MoE capacity buffer
// is x: tokens dropped by the dispatch are zero rows and flow through.  The
// reference pads M, K and N to its 128 blocks in the wrapper (ops.py:76-84);
// here the ragged edges are masked in the kernel (zero-filled loads, masked
// stores), so nothing is padded or copied in device memory.  x and w may be
// strided views (the stacked (L, E, D, F) expert weights are passed as layer
// slices): only the last dimension of each must be dense.
//
// What bounds it on an H100: at Mixtral's prefill (G 8, M = capacity 1280,
// K 4096, N 14336, bf16) the product is 1.20 TFLOP against 1.32 GB moved, so
// the tensor cores bound it (1.216 ms at 989 TFLOP/s against 0.39 ms of
// bytes).  At decode (M = 2) it is 1.9 GFLOP against the 940 MB of weights,
// which bound it (0.281 ms at 3.35 TB/s).  The design: a ring of kStages
// shared-memory stages fed by cp.async, so several weight tiles are in flight
// while the tensor cores work on the current one; blocks that share a weight
// tile are neighbours in launch order (the M tiles are blockIdx.x), so a
// weight tile comes from device memory once and from L2 for the other M
// tiles; and a 16-row block tile for small M, so the decode shape spends its
// block on weight bytes and not on 128 rows of zeros.
//
// Two routes by input type:
//  * bf16: tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate),
//    operands brought from shared memory with ldmatrix (.trans for w, which is
//    stored K-major).  bf16 products are exact in f32, so the result differs
//    from the plain version (an f32 einsum of the upcast inputs) only in the
//    order of the f32 sums before the one rounding.  Shared rows are padded by
//    16 bytes, which puts the 8 rows of each ldmatrix on distinct banks, for
//    any K or N (the row pitch in shared memory does not depend on them).
//    Tiles come in with 16-byte cp.async copies when every row of x and w
//    starts 16-byte aligned, else with plain loads (the kVec template flag).
//  * f32: full f32 on the CUDA cores, one fmaf per product, never TF32: the
//    plain version is an f32 einsum, and TF32 would keep 10 mantissa bits.
//
// Simple first: no TMA, wgmma, warp specialisation or persistent blocks yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const void* x;
  const void* w;
  void* out;
  int G, M, K, N;
  // element strides; the last dimension of each tensor has stride 1
  long long x_sg, x_sm;  // x (G, M, K)
  long long w_sg, w_sk;  // w (G, K, N)
  long long o_sg, o_sm;  // out (G, M, N)
};

// ---------------------------------------------------------------------------
// bf16 route: mma.sync tensor cores fed by a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kBK = 32;        // K depth of a stage
constexpr int kStages = 4;     // stages in flight
constexpr int kThreads = 256;  // 8 warps
constexpr int kLdA = kBK + 8;  // x tile row pitch (bf16): 80 bytes

template <int BM, int BN>
struct Tile {
  static constexpr int LDB = BN + 8;  // w tile row pitch (bf16)
  static constexpr int A_ELEMS = BM * kLdA;
  static constexpr int STAGE = A_ELEMS + kBK * LDB;
  static constexpr int SMEM = kStages * STAGE * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; only the first src_bytes are read, the rest
// of the 16 is zero-filled (src_bytes 0: a zero vector, nothing read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rows [m0, m0 + BM), columns [k0, k0 + kBK) of group slab xg into dst
// (pitch kLdA); rows at or past M and columns at or past K are zero.
template <int BM, bool kVec>
__device__ __forceinline__ void load_x_tile(__nv_bfloat16* dst, const __nv_bfloat16* xg,
                                            const Params& p, int m0, int k0) {
  constexpr int VPR = kBK / 8;
  for (int i = threadIdx.x; i < BM * VPR; i += kThreads) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    const int gm = m0 + r;
    const int gk = k0 + c;
    const bool row_ok = gm < p.M;
    __nv_bfloat16* d = dst + r * kLdA + c;
    const int n_valid = row_ok ? max(min(8, p.K - gk), 0) : 0;
    if (kVec) {
      cp_async16(d, n_valid ? xg + gm * p.x_sm + gk : xg, 2 * n_valid);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = e < n_valid ? xg[gm * p.x_sm + gk + e] : __float2bfloat16(0.f);
    }
  }
}

// w rows [k0, k0 + kBK), columns [n0, n0 + BN) of group slab wg into dst
// (pitch BN + 8); rows at or past K and columns at or past N are zero.
template <int BN, bool kVec>
__device__ __forceinline__ void load_w_tile(__nv_bfloat16* dst, const __nv_bfloat16* wg,
                                            const Params& p, int k0, int n0) {
  constexpr int LDB = BN + 8;
  constexpr int VPR = BN / 8;
  for (int i = threadIdx.x; i < kBK * VPR; i += kThreads) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    const int gk = k0 + r;
    const int gn = n0 + c;
    __nv_bfloat16* d = dst + r * LDB + c;
    const int n_valid = gk < p.K ? max(min(8, p.N - gn), 0) : 0;
    if (kVec) {
      cp_async16(d, n_valid ? wg + gk * p.w_sk + gn : wg, 2 * n_valid);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = e < n_valid ? wg[gk * p.w_sk + gn + e] : __float2bfloat16(0.f);
    }
  }
}

// One block: a BM x BN tile of out[g]; 8 warps as WM x WN, each warp a
// (BM / WM) x (BN / WN) tile of 16 x 8 mma fragments.
template <int BM, int BN, int WM, int WN, bool kVec>
__global__ void __launch_bounds__(kThreads) gmm_bf16(Params p) {
  using T = Tile<BM, BN>;
  constexpr int LDB = T::LDB;
  constexpr int WTM = BM / WM;
  constexpr int WTN = BN / WN;
  constexpr int MI = WTM / 16;
  constexpr int NI = WTN / 8;
  static_assert(WM * WN == kThreads / 32, "8 warps");
  static_assert(WTM % 16 == 0 && NI % 2 == 0, "warp tile of 16-row, 16-column pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int g = blockIdx.z;
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(p.x) + g * p.x_sg;
  const __nv_bfloat16* wg = static_cast<const __nv_bfloat16*>(p.w) + g * p.w_sg;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / WN;
  const int wn = warp % WN;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int n_ktiles = (p.K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_ktiles) {
      __nv_bfloat16* st = smem + s * T::STAGE;
      load_x_tile<BM, kVec>(st, xg, p, m0, s * kBK);
      load_w_tile<BN, kVec>(st + T::A_ELEMS, wg, p, s * kBK, n0);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < n_ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();               // ... everyone's; stage (kt - 1) is free
    const int nk = kt + kStages - 1;
    if (nk < n_ktiles) {
      __nv_bfloat16* st = smem + (nk % kStages) * T::STAGE;
      load_x_tile<BM, kVec>(st, xg, p, m0, nk * kBK);
      load_w_tile<BN, kVec>(st + T::A_ELEMS, wg, p, nk * kBK, n0);
    }
    cp_async_commit();

    const __nv_bfloat16* xs = smem + (kt % kStages) * T::STAGE;
    const __nv_bfloat16* ws = xs + T::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[MI][4];
      uint32_t b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[i], xs + (wm * WTM + i * 16 + (lane % 16)) * kLdA + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, ws + (kk + (lane % 16)) * LDB + wn * WTN + j * 8 + (lane / 16) * 8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out) + g * p.o_sg;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * WTM + i * 16 + (lane >> 2) + 8 * h;
      if (r >= p.M) continue;
      __nv_bfloat16* orow = og + r * p.o_sm;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = n0 + wn * WTN + j * 8 + 2 * (lane & 3);
        const float lo = acc[i][j][2 * h];
        const float hi = acc[i][j][2 * h + 1];
        // a pair store needs an even element offset from the 4-byte aligned base
        if (c + 1 < p.N && ((g * p.o_sg + r * p.o_sm + c) & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(lo, hi);
        } else {
          if (c < p.N) orow[c] = __float2bfloat16(lo);
          if (c + 1 < p.N) orow[c + 1] = __float2bfloat16(hi);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 route: fmaf on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kSimtBM = 64;
constexpr int kSimtBN = 64;
constexpr int kSimtBK = 16;

// 256 threads, each a 4 x 4 set of outputs at rows ty + 16 i, columns
// tx + 16 j, so a warp reads two x values (broadcast) and 16 consecutive w
// values per step.
__global__ void __launch_bounds__(kThreads) gmm_f32(Params p) {
  __shared__ float xs[kSimtBK][kSimtBM + 4];  // transposed: [k][m]
  __shared__ float ws[kSimtBK][kSimtBN + 4];
  const int m0 = blockIdx.x * kSimtBM;
  const int n0 = blockIdx.y * kSimtBN;
  const int g = blockIdx.z;
  const float* xg = static_cast<const float*>(p.x) + g * p.x_sg;
  const float* wgf = static_cast<const float*>(p.w) + g * p.w_sg;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kSimtBK) {
    for (int e = threadIdx.x; e < kSimtBM * kSimtBK; e += kThreads) {
      const int r = e / kSimtBK, c = e % kSimtBK;
      const bool ok = m0 + r < p.M && k0 + c < p.K;
      xs[c][r] = ok ? xg[(m0 + r) * p.x_sm + k0 + c] : 0.f;
    }
    for (int e = threadIdx.x; e < kSimtBK * kSimtBN; e += kThreads) {
      const int r = e / kSimtBN, c = e % kSimtBN;
      const bool ok = k0 + r < p.K && n0 + c < p.N;
      ws[r][c] = ok ? wgf[(k0 + r) * p.w_sk + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSimtBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* og = static_cast<float*>(p.out) + g * p.o_sg;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < p.N) og[r * p.o_sm + c] = acc[i][j];
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, const Params& p) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int BM, int BN, int WM, int WN>
cudaError_t launch_bf16(const Params& p, int vec, cudaStream_t st) {
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN, p.G);
  constexpr int smem = Tile<BM, BN>::SMEM;
  return vec ? launch(gmm_bf16<BM, BN, WM, WN, true>, grid, smem, st, p)
             : launch(gmm_bf16<BM, BN, WM, WN, false>, grid, smem, st, p);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike).  vec: 1 when x and
// w start 16-byte aligned and every row stride of both is a multiple of 8
// elements (bf16 only).  Returns the CUDA error code of the launch (0 on
// success); the kernel runs on `stream` and nothing is synchronised here.
int grouped_matmul(const void* x, const void* w, void* out, int dtype, int G, int M, int K,
                   int N, long long x_sg, long long x_sm, long long w_sg, long long w_sk,
                   long long o_sg, long long o_sm, int vec, void* stream) {
  const Params p{x, w, out, G, M, K, N, x_sg, x_sm, w_sg, w_sk, o_sg, o_sm};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > 65535 || M < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    if (M <= 16) return launch_bf16<16, 128, 1, 8>(p, vec, st);
    return launch_bf16<128, 128, 2, 4>(p, vec, st);
  }
  if (dtype == 0) {
    const dim3 grid((M + kSimtBM - 1) / kSimtBM, (N + kSimtBN - 1) / kSimtBN, G);
    return launch(gmm_f32, grid, 0, st, p);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* grouped_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
