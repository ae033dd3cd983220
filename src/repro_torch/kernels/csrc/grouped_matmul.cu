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
// or clipped stores), so nothing is padded or copied in device memory.  x and
// w may be strided views (the stacked (L, E, D, F) expert weights are passed
// as layer slices): only the last dimension of each must be dense.
//
// What bounds it on an H100: at Mixtral's prefill (G 8, M = capacity 1280,
// K 4096, N 14336, bf16) the product is 1.20 TFLOP against 1.32 GB moved, so
// the tensor cores bound it (1.216 ms at 989 TFLOP/s against 0.39 ms of
// bytes).  At decode (M = 2) it is 1.9 GFLOP against the 940 MB of weights,
// which bound it (0.2806 ms at 3.35 TB/s).
//
// Four routes, chosen by the wrapper from dtype, shapes, strides and
// alignment before the launch (grouped_matmul.py::route):
//  * wgmma (bf16, M > 16, every operand describable by TMA: bases 16-byte
//    aligned, every stride but the last a multiple of 8 elements).  The
//    prefill route, built the Hopper way:
//    - TMA loads over 3-D tensor maps (cols, rows, G) with the caller's
//      strides and 128-byte swizzle.  The out-of-bounds fill gives zeros for
//      ragged M, N and K (rows past M never reach the next group: G is its
//      own dimension), and the store clips them.
//    - Warp specialisation: one producer warpgroup (one thread of it issues
//      every copy) keeps a ring of 4 stages of (128 x 64 of x, 64 x
//      256 of w) in flight on full / empty mbarriers; two consumer
//      warpgroups, 64 rows each, issue wgmma.m64n256k16 on what has arrived
//      (x K-major; w stored (K, N) row-major, so MN-major: the transpose
//      bit), one k stage's group kept in flight while the next is waited
//      for.  setmaxnreg re-balances the register pool: 40 for the producer,
//      232 for the consumers.
//    - Persistent blocks, one per SM, walk the 128 x 256 output tiles in
//      the order (g, N tile, M tile), M fastest: the blocks in flight share
//      a few weight tiles, which come from device memory once and from L2
//      for the other M tiles.  The tile counter runs on across tiles, so the
//      producer loads the next tile while the consumers store this one.
//    - Epilogue: the f32 sums rounded to bf16 into two 64 x 64 staging
//      boxes per consumer warpgroup (swizzled as the out map), each written
//      by a TMA store, which drops rows past M and columns past N.
//    - Every mbarrier wait traps after about 2 s: a protocol fault fails the
//      launch instead of hanging the card.
//  * decode (bf16, M <= 16), a weight stream: at M = 2 the route moves 940 MB
//    of weights for 1.9 GFLOP, so it is the memory rate or nothing.
//    - Persistent blocks, one per SM, each an equal run of units: a unit is
//      64 K rows of a 512-column tile of one group, taken in the order (g,
//      tile, K), K fastest.  Equal runs leave no tail wave; a tile cut by a
//      run's end is split-K between consecutive blocks.
//    - A producer warp (its lane 0) keeps a ring of kSStages units in flight
//      through TMA on full / empty mbarriers: the unit's eight 64 x 64 w
//      boxes and x's box; 128-byte swizzle, zeros past M, K and N; the
//      weights under an L2 evict-first policy (they are read once).  3 x 66 KB per
//      SM, 26 MB across the card, against the 3.4 MB that 3.35 TB/s x 1 us
//      needs.  x rides with its unit: read once per K slice, from L2.
//    - Eight consumer warps, one w box each, compute out^T = w^T x^T with
//      mma.sync.m16n8k16: w^T through ldmatrix.trans as the A operand, x^T
//      as the n8 B operand, so M <= 8 spends no tensor-core work on a
//      16-row tile of zeros (M <= 16: two n8 tiles).
//    - Split-K in a fixed order: each part of a split tile goes to an f32
//      scratch slot; the last of its blocks to arrive (a per-tile counter,
//      which that block resets) sums the parts in ascending block order,
//      rounds once and stores.  Repeated launches give the same bits.
//    Where TMA cannot describe x or w (an unaligned row), the route runs the
//    16 x 128 mma.sync tile below with plain loads instead.
//    The unit's shape, the warps, the ring's depth, the L2 policy and a
//    one-copy 4-D map were each timed in turns against alternatives
//    (DESIGN_TORCH.md section 14).
//  * 128 x 128 mma.sync (bf16 that TMA cannot describe: an odd K stride, an
//    unaligned view): tensor cores through mma.sync.m16n8k16 fed by a
//    cp.async ring of kStages stages; the 16 x 128 tile of the same kernel
//    takes the decode route's unaligned rows.  Operands come from shared
//    memory with ldmatrix (.trans for w), shared rows padded by 16 bytes (the
//    8 rows of each ldmatrix on distinct banks); tiles come in with 16-byte
//    cp.async copies when every row of x and w starts 16-byte aligned, else
//    with plain loads (kVec).
//  * f32: full f32 on the CUDA cores, one fmaf per product, never TF32: the
//    plain version is an f32 einsum, and TF32 would keep 10 mantissa bits.
// bf16 products are exact in f32, so every bf16 route differs from the plain
// version (an f32 einsum of the upcast inputs) only in the order of the f32
// sums before the one rounding.
//
// The backward (grouped_matmul_strided): dx[g] = dy[g] @ w[g]ᵀ and dw[g] =
// x[g]ᵀ @ dy[g], each with an f32 accumulator rounded once to x's type.  The
// reference has no Pallas backward: its MoE trains through the VJP of its
// einsums, which these two products are.  Both are the forward's products
// on other operand layouts, so they run the same kernels on views:
//  * wgmma (bf16, capacity M > 16, every operand describable by TMA): the
//    prefill kernel above with wgmma's transpose bits and the TMA boxes set
//    per operand.  dx's A (dy) is K-major as the forward's x is, its B (wᵀ)
//    K-major: w's rows are read as the tile's n rows.  dw's A (xᵀ) is
//    MN-major: x's rows are the tile's k rows, so the ragged capacity is
//    TMA's zero fill, as ragged K is in the forward; its B (dy) is MN-major
//    as the forward's w is.  dw's contraction is the capacity, short (7.5
//    stages of 64 at moonshot's 480): its stages are 80 capacity rows deep
//    where that leaves fewer zero rows (480 = 6 x 80), 64 elsewhere, chosen
//    from shapes before the launch (grouped_matmul.py::bwd_schedule).  The
//    other schedules tried for the backward (bands of M tiles, ping-pong
//    consumers, 128-wide tiles) were removed after their card readings
//    (DESIGN_TORCH.md section 18).  At Mixtral's shapes each product is 1.20 TFLOP,
//    bound by the tensor cores (1.216 ms), as the forward.
//  * strided (f32, M <= 16, views TMA cannot describe): the f32 route's
//    fmaf kernel on all three strides of each operand, in f32 or bf16.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

struct Params {
  const void* x;
  const void* w;
  void* out;
  int G, M, K, N;
  // element strides; the forward's x and w have x_sk = w_sn = 1 (the
  // backward passes views: dy wᵀ and xᵀ dy), out (G, M, N) is dense in N
  long long x_sg, x_sm, x_sk;  // x (G, M, K)
  long long w_sg, w_sk, w_sn;  // w (G, K, N)
  long long o_sg, o_sm;        // out (G, M, N)
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
// f32 route, and the backward's strided route: fmaf on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kSimtBM = 64;
constexpr int kSimtBN = 64;
constexpr int kSimtBK = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 256 threads, each a 4 x 4 set of outputs at rows ty + 16 i, columns
// tx + 16 j, so a warp reads two x values (broadcast) and 16 consecutive w
// values per step.  x and w are read through all three of their strides
// (any may be 0 or more than 1), neighbouring threads along whichever of a
// tile's two dimensions has stride 1; the product of each pair is exact in
// f32 for bf16 inputs, summed over k in order, rounded once.
template <typename T>
__global__ void __launch_bounds__(kThreads) gmm_simt(Params p) {
  __shared__ float xs[kSimtBK][kSimtBM + 4];  // transposed: [k][m]
  __shared__ float ws[kSimtBK][kSimtBN + 4];
  const int m0 = blockIdx.x * kSimtBM;
  const int n0 = blockIdx.y * kSimtBN;
  const int g = blockIdx.z;
  const T* xg = static_cast<const T*>(p.x) + g * p.x_sg;
  const T* wgf = static_cast<const T*>(p.w) + g * p.w_sg;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const bool x_k_dense = p.x_sk == 1, w_n_dense = p.w_sn == 1;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kSimtBK) {
    for (int e = threadIdx.x; e < kSimtBM * kSimtBK; e += kThreads) {
      const int r = x_k_dense ? e / kSimtBK : e % kSimtBM;
      const int c = x_k_dense ? e % kSimtBK : e / kSimtBM;
      const bool ok = m0 + r < p.M && k0 + c < p.K;
      xs[c][r] = ok ? to_f32(xg[(m0 + r) * p.x_sm + (k0 + c) * p.x_sk]) : 0.f;
    }
    for (int e = threadIdx.x; e < kSimtBK * kSimtBN; e += kThreads) {
      const int r = w_n_dense ? e / kSimtBN : e % kSimtBK;
      const int c = w_n_dense ? e % kSimtBN : e / kSimtBK;
      const bool ok = k0 + r < p.K && n0 + c < p.N;
      ws[r][c] = ok ? to_f32(wgf[(k0 + r) * p.w_sk + (n0 + c) * p.w_sn]) : 0.f;
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
  T* og = static_cast<T*>(p.out) + g * p.o_sg;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < p.N) store_f32(og + r * p.o_sm + c, acc[i][j]);
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 prefill route: TMA, wgmma, a producer warpgroup, two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kWBM = 128;          // tile rows: two consumer warpgroups x 64
constexpr int kWBN = 256;          // tile columns: one m64n256k16 per warpgroup and k step
constexpr int kWBK = 64;           // K per stage: one 128-byte swizzle row of x
constexpr int kWConsumers = 256;   // threads of the two consumer warpgroups
// and a producer warpgroup, of which one thread issues every copy: the
// block's register pool is sized for 384 threads at launch (168 each), and
// setmaxnreg moves registers within it: 128 x 40 + 256 x 232 = 384 x 168.
constexpr int kWThreads = kWConsumers + 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBox = 64;           // columns per TMA box: one 128-byte swizzle row
constexpr int kRowBytes = 128;     // bytes of a box row in shared memory
constexpr int kOutBox = 64 * kBox * 2;            // a 64 x 64 staging box of out
constexpr int kOutBufs = 2;                       // staging boxes per consumer warpgroup
constexpr int kStoreBar = 1;       // named barriers kStoreBar + warpgroup

// The ring of stages of kBK contraction rows (kWBK; 80 for the backward's dw,
// gmm_wgmma), each x's tile (128 rows) then w's (kWBN / 64 boxes), as many
// stages as shared memory holds beside the staging boxes: 4 of 48 KB at kWBK,
// 3 of 60 KB at 80.
template <int kBK>
struct WRing {
  static constexpr int kABytes = kWBM * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBK * kWBN * 2;
  // each stage its tiles and its two mbarriers
  static constexpr int kStages = (232448 - 1024 - 2 * kOutBufs * kOutBox) / (kStageBytes + 16);
  // 1024-byte alignment slack (the 128-byte swizzle), the ring, the staging
  // boxes, then the full and empty mbarriers
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kOutBufs * kOutBox + 16 * kStages;
  static_assert(kBK % 16 == 0 && (kBK * kRowBytes) % 1024 == 0, "k steps of 16, aligned boxes");
};
static_assert(WRing<kWBK>::kStages == 4 && WRing<80>::kStages == 3, "the rings described above");
// An mbarrier wait that lasts this long (about 2 s) is a protocol fault: the
// kernel traps, so the launch fails instead of hanging the card.
constexpr long long kWaitCycles = 1ll << 32;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Returns once the phase of parity `parity` has completed; traps after
// kWaitCycles.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > kWaitCycles) __trap();
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// One box of a 3-D (cols, rows, G) tensor map into shared memory; completion
// is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int g) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(g), "r"(bar)
      : "memory");
}

// L2 policy for data read once: evict it first.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// tma_load under the L2 policy `pol`.
__device__ __forceinline__ void tma_load_hint(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int col, int row, int g, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(g), "r"(bar), "l"(pol)
      : "memory");
}

// One box from shared memory into the 3-D tensor map; the bulk group tracks
// completion.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col, int row,
                                          int g) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row), "r"(g)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (m64 x n256, f32) = (scale_d ? d : 0) + a (smem) * b (smem); a is K-major
// (kAT 0) or MN-major (1), b K-major (kBT 0) or MN-major (1): wgmma's
// transpose bits.
template <int kAT, int kBT>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kAT), "n"(kBT));
}

// Output tiles in the order (g, N tile, M tile), M fastest; K in stages of
// bk rows (grouped_matmul.py::BwdSchedule.decode mirrors the order).
struct TileGrid {
  int n_m, n_n, n_k, n_tiles;
  __device__ TileGrid(const Params& p, int bk)
      : n_m((p.M + kWBM - 1) / kWBM),
        n_n((p.N + kWBN - 1) / kWBN),
        n_k((p.K + bk - 1) / bk),
        n_tiles(p.G * n_m * n_n) {}
  __device__ void decode(int t, int& g, int& m0, int& n0) const {
    m0 = (t % n_m) * kWBM;
    const int rest = t / n_m;
    n0 = (rest % n_n) * kWBN;
    g = rest / n_n;
  }
};

// Persistent: block b takes tiles b, b + gridDim.x, ...  Shared memory
// (1024-byte aligned): the ring of WRing<kBK> stages, each the x tile (128
// rows x kBK k: 128 bytes a row) then the w tile (kWBN / 64 boxes of kBK or
// 64 rows x 128 bytes); the staging boxes, kOutBufs per consumer warpgroup;
// the mbarriers full[], empty[].
// Operand layouts (the backward's products pass views): x (the A operand)
// is K-major (kAT 0: one box of 128 m rows x 64 k) or MN-major (kAT 1: x
// stored k by m, two boxes of kBK k rows x 64 m, one per consumer
// warpgroup); w (B) is MN-major (kBT 1: stored k by n, kWBN / 64 boxes of
// kBK k rows x 64 n) or K-major (kBT 0: stored n by k, kWBN / 64 boxes of 64
// n rows x 64 k).  Every box row is 128 swizzled bytes, so a tile sits at the
// same offsets in either layout at kBK 64: 64 K-major rows or 64 MN-major k
// rows per 8 KB.  A stage deeper than one swizzle row of k (kBK 80) needs
// both operands MN-major, where k runs down the boxes' rows.
// The forward is <0, 1, kWBK>, dx = dy wᵀ <0, 0, kWBK>, dw = xᵀ dy <1, 1,
// kWBK or 80> (grouped_matmul.py::bwd_schedule picks the depth).
template <int kAT, int kBT, int kBK = kWBK>
__global__ void __launch_bounds__(kWThreads, 1)
    gmm_wgmma(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
              const __grid_constant__ CUtensorMap tm_o, const Params p) {
  static_assert(kBK == kWBK || (kAT && kBT), "a stage of other than 64 k needs MN-major operands");
  constexpr int kWStages = WRing<kBK>::kStages;
  constexpr int kWStageBytes = WRing<kBK>::kStageBytes;
  constexpr int kABytes = WRing<kBK>::kABytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t stage_out = ring + kWStages * kWStageBytes;
  const uint32_t full_bar = stage_out + 2 * kOutBufs * kOutBox;
  const uint32_t empty_bar = full_bar + 8 * kWStages;
  const TileGrid tg(p, kBK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kWConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWConsumers) {
    // Producer warpgroup: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kWConsumers) {
      int it = 0;  // stages issued so far: the ring's position
      for (int t = blockIdx.x; t < tg.n_tiles; t += gridDim.x) {
        int g, m0, n0;
        tg.decode(t, g, m0, n0);
        for (int kt = 0; kt < tg.n_k; ++kt, ++it) {
          const int s = it % kWStages;
          // the consumers released this stage's previous k step (passes at
          // once on the first round)
          mbar_wait(empty_bar + 8 * s, ((it / kWStages) & 1) ^ 1);
          mbar_expect_tx(full_bar + 8 * s, kWStageBytes);
          const uint32_t a = ring + s * kWStageBytes;
          const int k0 = kt * kBK;
          if (kAT) {
#pragma unroll
            for (int j = 0; j < kWBM / kBox; ++j)
              tma_load(a + j * kBK * kRowBytes, &tm_x, full_bar + 8 * s, m0 + j * kBox, k0, g);
          } else {
            tma_load(a, &tm_x, full_bar + 8 * s, k0, m0, g);
          }
#pragma unroll
          for (int j = 0; j < kWBN / kBox; ++j) {
            const uint32_t box = a + kABytes + j * (kBT ? kBK : kBox) * kRowBytes;
            if (kBT)
              tma_load(box, &tm_w, full_bar + 8 * s, n0 + j * kBox, k0, g);
            else
              tma_load(box, &tm_w, full_bar + 8 * s, k0, n0 + j * kBox, g);
          }
        }
      }
    }
  } else {
    // Consumer warpgroups: rows wg * 64 .. wg * 64 + 63 of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const bool storer = threadIdx.x % 128 == 0;
    float acc[kWBN / 2];
#pragma unroll
    for (int e = 0; e < kWBN / 2; ++e) acc[e] = 0.f;
    int it = 0;
    for (int t = blockIdx.x; t < tg.n_tiles; t += gridDim.x) {
      int g, m0, n0;
      tg.decode(t, g, m0, n0);
      for (int kt = 0; kt < tg.n_k; ++kt, ++it) {
        const int s = it % kWStages;
        mbar_wait(full_bar + 8 * s, (it / kWStages) & 1);
        const uint32_t a = ring + s * kWStageBytes + wg * (kAT ? kBK : 64) * kRowBytes;
        const uint32_t b = ring + s * kWStageBytes + kABytes;
        fence_regs(acc);
        wgmma_fence();
        // kBK / 16 k steps of 16: K-major, 16 columns (32 bytes) inside the
        // 128-byte swizzle row, 8-row groups 1024 bytes apart; MN-major, 16
        // rows of 128 bytes, 8-row groups 1024 bytes apart, its 64-column
        // boxes kBK rows apart
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_n256<kAT, kBT>(
              acc,
              kAT ? smem_desc(a + kk * 16 * kRowBytes, kBK * kRowBytes, 1024)
                  : smem_desc(a + kk * 32, 16, 1024),
              kBT ? smem_desc(b + kk * 16 * kRowBytes, kBK * kRowBytes, 1024)
                  : smem_desc(b + kk * 32, 16, 1024),
              kt > 0 || kk > 0);
        wgmma_commit();
        fence_regs(acc);
        // the previous k step's products are done: release its stage
        if (kt > 0) {
          wgmma_wait<1>();
          fence_regs(acc);
          mbar_arrive(empty_bar + 8 * ((it - 1) % kWStages));
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty_bar + 8 * ((it - 1) % kWStages));

      // Epilogue: this warpgroup's 64 x 256 in four 64 x 64 boxes, rounded to
      // bf16 into a staging box in the out map's swizzled layout and stored
      // by TMA; two staging boxes, so one is filled while the other's store
      // reads it.  A box wholly past M or N is not stored.
      const int row0 = m0 + wg * 64;
#pragma unroll
      for (int j = 0; j < kWBN / kBox; ++j) {
        const uint32_t buf = stage_out + (wg * kOutBufs + (j & 1)) * kOutBox;
        // the store that last read this staging box has finished reading it
        if (storer) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        named_bar_sync(kStoreBar + wg, 128);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int lr = warp * 16 + lane / 4 + 8 * i;  // row within the warpgroup
#pragma unroll
          for (int c = 0; c < 8; ++c) {  // 8-column groups of the box
            const int n = j * 8 + c;     // 8-column group of the tile
            st_shared(buf + lr * kRowBytes + ((c ^ (lr % 8)) * 16) + (lane & 3) * 4,
                      pack_f32(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]));
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_bar_sync(kStoreBar + wg, 128);
        if (storer) {
          if (row0 < p.M && n0 + j * kBox < p.N) tma_store(&tm_o, buf, n0 + j * kBox, row0, g);
          // a group per box, empty where nothing was stored, so "all but the
          // newest group" above always means the box's previous store
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
    }
    if (storer) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// Errors of the tensor-map encoder come back as kMapError + CUresult.
constexpr int kMapError = 100000;

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that the
// library needs no -lcuda.
PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr)
               : nullptr;
  }();
  return fn;
}

// The 3-D map (cols, rows, G) of a bf16 (G, rows, cols) view with element
// strides s_row, s_g (cols dense): boxes of 64 columns x `box_rows` rows,
// 128-byte swizzle, zeros for what lies past the extents.
int encode_map(CUtensorMap* map, const void* ptr, int cols, int rows, int G, long long s_row,
               long long s_g, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encoder();
  if (encode == nullptr) return kMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)s_row * 2, (cuuint64_t)s_g * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + static_cast<int>(r);
}

constexpr int kMaxDevices = 64;

// Streaming multiprocessors of the current device, read once per device.
int sm_count(int& sms) {
  static int counts[kMaxDevices] = {};
  static std::mutex lock;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(lock);
  if (counts[dev] == 0) {
    e = cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  sms = counts[dev];
  return cudaSuccess;
}

// The maps of x and w follow their layouts (gmm_wgmma): the dense dimension
// is the map's columns, the other its rows.
// The runtime calls come first: they make the device's primary context
// current on the calling thread (autograd's device thread may have none yet),
// which cuTensorMapEncodeTiled needs.
template <int kAT, int kBT, int kBK = kWBK>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  constexpr int kWSmem = WRing<kBK>::kSmem;
  auto kernel = gmm_wgmma<kAT, kBT, kBK>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
  if (e != cudaSuccess) return e;
  int sms = 0;
  int err = sm_count(sms);
  if (err) return err;
  CUtensorMap tm_x, tm_w, tm_o;
  err = kAT ? encode_map(&tm_x, p.x, p.M, p.K, p.G, p.x_sk, p.x_sg, kBK)
            : encode_map(&tm_x, p.x, p.K, p.M, p.G, p.x_sm, p.x_sg, kWBM);
  if (!err)
    err = kBT ? encode_map(&tm_w, p.w, p.N, p.K, p.G, p.w_sk, p.w_sg, kBK)
              : encode_map(&tm_w, p.w, p.K, p.N, p.G, p.w_sn, p.w_sg, kBox);
  if (!err) err = encode_map(&tm_o, p.out, p.N, p.M, p.G, p.o_sm, p.o_sg, 64);
  if (err) return err;
  const long long tiles = (long long)p.G * ((p.M + kWBM - 1) / kWBM) * ((p.N + kWBN - 1) / kWBN);
  const dim3 grid(static_cast<unsigned>(tiles < sms ? tiles : sms));
  kernel<<<grid, kWThreads, kWSmem, stream>>>(tm_x, tm_w, tm_o, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 decode route (M <= 16): the weight stream
// ---------------------------------------------------------------------------

constexpr int kSBK = 64;                          // K rows of a unit (one ring stage): 16 to 256
constexpr int kSBoxes = 8;                        // 64-column w boxes per unit
constexpr int kSBN = kSBoxes * kBox;              // columns of a tile
constexpr int kSStages = 3;                       // ring stages per block
constexpr int kSWBytes = kSBK * kRowBytes;        // one w box: kSBK rows x 128 bytes
constexpr int kSXBoxes = (kSBK + kBox - 1) / kBox; // x boxes of a unit, 64 K each
constexpr int kSXBytes = 16 * kRowBytes;          // an x box: up to 16 rows x 64 k
constexpr int kSStageBytes = kSBoxes * kSWBytes + kSXBoxes * kSXBytes;  // a 1024-byte multiple
constexpr int kSConsumers = 256;                  // consumer warps, kSBoxes / kSWarps w boxes each
constexpr int kSWarps = kSConsumers / 32;
constexpr int kSThreads = kSConsumers + 32;       // and a producer warp
constexpr int kSGroups = 4 * kSBoxes / kSWarps;   // 16-column groups of a consumer warp
constexpr int kSSmem = 1024 + kSStages * kSStageBytes + 16 * kSStages;
constexpr int kSFinishBar = 1;                    // named barrier of the consumer warps
static_assert(kSBoxes % kSWarps == 0 && kSBK % 16 == 0 && kSBK <= 256, "stream unit shape");
static_assert(kSSmem <= 232448, "the ring fits in shared memory");

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// The split of the (g, column tile, unit) sequence, K fastest, over the
// grid: block b takes units [b U / blocks, (b + 1) U / blocks).  The same
// arithmetic as grouped_matmul.py::stream_plan.
struct Stream {
  int n_tiles, ku;  // column tiles per group, units per tile
  long long units;
  int blocks;
  __device__ Stream(const Params& p, int nb)
      : n_tiles((p.N + kSBN - 1) / kSBN),
        ku((p.K + kSBK - 1) / kSBK),
        units((long long)p.G * n_tiles * ku),
        blocks(nb) {}
  __device__ long long start(int b) const { return (long long)b * units / blocks; }
  // the block whose run holds unit u
  __device__ int owner(long long u) const {
    return (int)(((u + 1) * blocks + units - 1) / units - 1);
  }
  // scratch slot of block b's part of tile t: 0 for the first tile of its
  // run, 1 for the last (a block splits at most those two)
  __device__ int slot(int b, long long t) const {
    return 2 * b + (t == start(b) / ku ? 0 : 1);
  }
};

// Persistent: one block per SM takes an equal run of units.
// Shared memory (1024-byte aligned for the 128-byte swizzle): a ring of
// kSStages stages, each kSBoxes w boxes (kSBK K rows x 64 columns) and
// kSXBoxes x boxes (8 MT rows x 64 K), then the full and empty mbarriers.
// The producer warp's lane 0 issues every copy; each consumer warp
// multiplies its kSBoxes / kSWarps boxes: out^T (its columns x M) = w^T x^T, w^T as
// ldmatrix.trans A fragments, x^T as B fragments (M <= 8 fills the n8 side:
// no 16-row tile of zeros).  A tile whose units all lie in
// the block's run is rounded and stored; a part of a tile goes to the f32
// scratch `part`, and the last of the tile's blocks to arrive (a counter per
// tile in `arrivals`, reset by that block) sums every part in ascending block
// order, rounds once and stores.
template <int MT>
__global__ void __launch_bounds__(kSThreads, 1)
    gmm_stream(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
               const Params p,
               float* __restrict__ part, int* __restrict__ arrivals) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int finisher;
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full_bar = ring + kSStages * kSStageBytes;
  const uint32_t empty_bar = full_bar + 8 * kSStages;
  const Stream sp(p, gridDim.x);
  const long long u_begin = sp.start(blockIdx.x), u_end = sp.start(blockIdx.x + 1);
  constexpr uint32_t kTx = kSBoxes * kSWBytes + kSXBoxes * MT * 8 * kRowBytes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kSWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kSConsumers) {
    if (threadIdx.x == kSConsumers) {
      const uint64_t stream_once = evict_first_policy();  // the weights are read once
      int it = 0;
      for (long long u = u_begin; u < u_end; ++u, ++it) {
        const int s = it % kSStages;
        mbar_wait(empty_bar + 8 * s, ((it / kSStages) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * s, kTx);
        const long long t = u / sp.ku;
        const int k0 = (int)(u - t * sp.ku) * kSBK;
        const int g = (int)(t / sp.n_tiles);
        const int n0 = (int)(t % sp.n_tiles) * kSBN;
        const uint32_t st = ring + s * kSStageBytes;
#pragma unroll
        for (int j = 0; j < kSBoxes; ++j)
          tma_load_hint(st + j * kSWBytes, &tm_w, full_bar + 8 * s, n0 + j * kBox, k0, g,
                        stream_once);
#pragma unroll
        for (int j = 0; j < kSXBoxes; ++j)
          tma_load(st + kSBoxes * kSWBytes + j * kSXBytes, &tm_x, full_bar + 8 * s, k0 + j * kBox,
                   0, g);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int lm = lane >> 3, li = lane & 7;  // ldmatrix: matrix and row of this lane's address
  int it = 0;
  long long u = u_begin;
  while (u < u_end) {
    const long long t = u / sp.ku;
    const long long t_begin = t * sp.ku, t_end = t_begin + sp.ku;
    const long long seg_end = t_end < u_end ? t_end : u_end;
    const bool whole = u == t_begin && seg_end == t_end;
    float acc[kSGroups][MT][4];
#pragma unroll
    for (int j = 0; j < kSGroups; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[j][m][0] = acc[j][m][1] = acc[j][m][2] = acc[j][m][3] = 0.f;

    // acc += this warp's boxes of stage s times the stage's x
    auto mma_unit = [&](int s) {
      const uint32_t wbox = ring + s * kSStageBytes + warp * (kSBoxes / kSWarps) * kSWBytes;
      const uint32_t xbox = ring + s * kSStageBytes + kSBoxes * kSWBytes;
#pragma unroll
      for (int kk = 0; kk < kSBK / 16; ++kk) {
        // B fragments: x[m][k0 + kk*16 + 2tq (+8)], rows of the swizzled x
        // box kk / 4
        uint32_t bx[MT][2];
        const uint32_t xb = xbox + (kk / 4) * kSXBytes;
        const int c = 2 * (kk % 4);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int row = m * 8 + gq;
          bx[m][0] = ld_shared(xb + row * kRowBytes + ((c ^ (row & 7)) << 4) + tq * 4);
          bx[m][1] = ld_shared(xb + row * kRowBytes + (((c + 1) ^ (row & 7)) << 4) + tq * 4);
        }
        // A fragments: w^T (16 columns x 16 k) by ldmatrix.trans of the k
        // rows kk*16 + (lm / 2) * 8 + li of box j / 4, 16-byte chunk
        // 2 (j % 4) + lm % 2
        const int krow = kk * 16 + (lm >> 1) * 8 + li;
#pragma unroll
        for (int j = 0; j < kSGroups; ++j) {
          uint32_t a[4];
          ldsm_x4_trans(a, wbox + (j / 4) * kSWBytes + krow * kRowBytes +
                               (((2 * (j % 4) + (lm & 1)) ^ li) << 4));
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_16816(acc[j][m], a, bx[m][0], bx[m][1]);
        }
      }
    };
    for (; u < seg_end; ++u, ++it) {
      const int s = it % kSStages;
      mbar_wait(full_bar + 8 * s, (it / kSStages) & 1);
      mma_unit(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * s);
    }

    // acc[j][m]: rows (columns of out) n0 + warp*kSGroups*16 + j*16 + gq
    // (+8), columns (rows of out) m*8 + 2tq (+1)
    const int g = (int)(t / sp.n_tiles);
    const int ncol = (int)(t % sp.n_tiles) * kSBN + warp * kSGroups * 16 + gq;
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out) + g * p.o_sg;
    if (!whole) {
      float4* mine = reinterpret_cast<float4*>(part) +
                     ((long long)sp.slot(blockIdx.x, t) * kSConsumers + threadIdx.x) * kSGroups * MT;
#pragma unroll
      for (int j = 0; j < kSGroups; ++j)
#pragma unroll
        for (int m = 0; m < MT; ++m)
          mine[j * MT + m] = make_float4(acc[j][m][0], acc[j][m][1], acc[j][m][2], acc[j][m][3]);
      __threadfence();
      named_bar_sync(kSFinishBar, kSConsumers);
      const int b_first = sp.owner(t_begin), b_last = sp.owner(t_end - 1);
      if (threadIdx.x == 0) {
        const int arrived = atomicAdd(arrivals + b_first, 1);
        finisher = arrived == b_last - b_first;
        if (finisher) arrivals[b_first] = 0;  // ready for the next launch
      }
      named_bar_sync(kSFinishBar, kSConsumers);
      if (!finisher) continue;
      __threadfence();
#pragma unroll
      for (int j = 0; j < kSGroups; ++j)
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[j][m][0] = acc[j][m][1] = acc[j][m][2] = acc[j][m][3] = 0.f;
      for (int b = b_first; b <= b_last; ++b) {
        const float4* theirs = reinterpret_cast<const float4*>(part) +
                               ((long long)sp.slot(b, t) * kSConsumers + threadIdx.x) * kSGroups * MT;
#pragma unroll
        for (int j = 0; j < kSGroups; ++j)
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float4 v = __ldcg(theirs + j * MT + m);
            acc[j][m][0] += v.x;
            acc[j][m][1] += v.y;
            acc[j][m][2] += v.z;
            acc[j][m][3] += v.w;
          }
      }
    }
#pragma unroll
    for (int j = 0; j < kSGroups; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = ncol + j * 16 + (e >> 1) * 8;
          const int r = m * 8 + 2 * tq + (e & 1);
          if (n < p.N && r < p.M) og[r * p.o_sm + n] = __float2bfloat16(acc[j][m][e]);
        }
  }
}

// The fmaf route's grid: a block per 64 x 64 output tile of each group.
dim3 simt_grid(const Params& p) {
  return dim3((p.M + kSimtBM - 1) / kSimtBM, (p.N + kSimtBN - 1) / kSimtBN, p.G);
}

// The decode route: the weight stream where TMA can describe x and w (bases
// 16-byte aligned, every stride but the last a positive multiple of 8
// elements: `blocks` > 0), else the 16 x 128 mma.sync tile with plain loads.
int launch_decode(const Params& p, int blocks, float* part, int* arrivals, cudaStream_t stream) {
  if (blocks <= 0) {
    const dim3 grid((p.M + 15) / 16, (p.N + 127) / 128, p.G);
    return launch(gmm_bf16<16, 128, 1, 8, false>, dim3(grid), Tile<16, 128>::SMEM, stream, p);
  }
  if (p.M > 16) return cudaErrorInvalidValue;
  const int mt = p.M <= 8 ? 1 : 2;
  auto kernel = mt == 1 ? gmm_stream<1> : gmm_stream<2>;
  // the runtime first, as in launch_wgmma
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSSmem);
  if (e != cudaSuccess) return e;
  CUtensorMap tm_x, tm_w;
  int err = encode_map(&tm_x, p.x, p.K, p.M, p.G, p.x_sm, p.x_sg, 8 * mt);
  if (!err) err = encode_map(&tm_w, p.w, p.N, p.K, p.G, p.w_sk, p.w_sg, kSBK);
  if (err) return err;
  kernel<<<blocks, kSThreads, kSSmem, stream>>>(tm_x, tm_w, p, part, arrivals);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// route: 0 f32 (float32 in and out), 1 decode (M <= 16: the weight stream,
// or the 16-row mma.sync tile where TMA cannot describe x or w), 2 the 128 x
// 128 mma.sync tile, 3 wgmma + TMA (bf16 routes: x, w and out bfloat16).
// vec (route 2): 1 when x and w start 16-byte aligned and every row stride of
// both is a multiple of 8 elements.  blocks (route 1): the weight stream's
// grid (grouped_matmul.py::stream_plan), 0 for the 16-row tile; part: its f32
// scratch, 2 x 128 x 16 x ceil(M / 8) floats per block; arrivals: `blocks`
// ints, zero before the first launch, left zero by every launch (launches
// that share them run in order on one stream).  Returns 0 on success, else
// the CUDA error code of the launch, or 100000 + the CUresult of a tensor map
// that could not be encoded; the kernel runs on `stream` and nothing is
// synchronised here.
int grouped_matmul(const void* x, const void* w, void* out, int route, int G, int M, int K,
                   int N, long long x_sg, long long x_sm, long long w_sg, long long w_sk,
                   long long o_sg, long long o_sm, int vec, int blocks, float* part,
                   int* arrivals, void* stream) {
  const Params p{x, w, out, G, M, K, N, x_sg, x_sm, 1, w_sg, w_sk, 1, o_sg, o_sm};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > 65535 || M < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (route) {
    case 0: return launch(gmm_simt<float>, simt_grid(p), 0, st, p);
    case 1: return launch_decode(p, blocks, part, arrivals, st);
    case 2: return launch_bf16<128, 128, 2, 4>(p, vec, st);
    case 3: return launch_wgmma<0, 1>(p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward's two products, out[g] = a[g] @ b[g] for a (G, M, K) and
// b (G, K, N) given by their element strides (the wrapper passes views:
// dx = dy wᵀ with a = dy, b = wᵀ; dw = xᵀ dy with a = xᵀ, b = dy); out
// (G, M, N) is dense in N.  route: 0 the strided fmaf route in f32 (a, b
// and out float32), 1 the same for bfloat16, 2 wgmma + TMA with a and b
// K-major (a_sk = b_sk = 1: dx), 3 wgmma + TMA with a and b MN-major
// (a_sm = b_sn = 1: dw); routes 2 and 3 need bfloat16 and every stride of a,
// b and out but the unit one a positive multiple of 8 elements, bases
// 16-byte aligned, and take the k depth of a stage, tile_k
// (grouped_matmul.py::bwd_schedule): 64, or on route 3 also 80; any other is
// refused.  Routes 0 and 1 ignore it.  Returns as grouped_matmul does.
int grouped_matmul_strided(const void* a, const void* b, void* out, int route, int G, int M,
                           int K, int N, long long a_sg, long long a_sm, long long a_sk,
                           long long b_sg, long long b_sk, long long b_sn, long long o_sg,
                           long long o_sm, int tile_k, void* stream) {
  const Params p{a, b, out, G, M, K, N, a_sg, a_sm, a_sk, b_sg, b_sk, b_sn, o_sg, o_sm};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > 65535 || M < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (route) {
    case 0: return launch(gmm_simt<float>, simt_grid(p), 0, st, p);
    case 1: return launch(gmm_simt<__nv_bfloat16>, simt_grid(p), 0, st, p);
    case 2:
      if (a_sk != 1 || b_sk != 1 || tile_k != kWBK) return static_cast<int>(cudaErrorInvalidValue);
      return launch_wgmma<0, 0>(p, st);
    case 3:
      if (a_sm != 1 || b_sn != 1) return static_cast<int>(cudaErrorInvalidValue);
      if (tile_k == kWBK) return launch_wgmma<1, 1>(p, st);
      if (tile_k == 80) return launch_wgmma<1, 1, 80>(p, st);
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The decode route's weight stream: 0 columns of a tile (kSBN), 1 K rows of
// a unit (kSBK), 2 consumer threads (kSConsumers); grouped_matmul.py's
// stream_plan holds the same numbers.
int grouped_matmul_stream_geometry(int which) {
  switch (which) {
    case 0: return kSBN;
    case 1: return kSBK;
    case 2: return kSConsumers;
  }
  return -1;
}

const char* grouped_matmul_error_string(int err) {
  if (err >= kMapError) return "cuTensorMapEncodeTiled failed (CUresult = code - 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
