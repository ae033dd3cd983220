// Flash-attention forward for Hopper (sm_90a), with a plain C interface that
// kernels/flash_attention.py loads through ctypes.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel, the Pallas TPU
// kernel behind repro.kernels.flash_attention.flash_attention_fwd.  Same
// function: online-softmax attention forward over q (B, Hq, Sq, d) and
// k, v (B, Hkv, Sk, d) with causal, bidirectional and sliding-window masks, a
// k_len limit on the keys, and GQA (kv head = h / (Hq / Hkv)).  The masked-entry
// sentinel is the finite -1e30 of the reference, never -inf: a row that meets a
// fully masked tile before its first valid key gets p = exp(0) = 1 there, and
// the first valid tile wipes that out with corr = exp(-1e30 - m) = 0.  The
// final divide is by max(l, 1e-30), as in the reference.  A query row that
// has no valid key at all (only possible through k_len or a window) has no
// defined output: the reference kernel and its dense oracle disagree there too.
//
// What bounds it on an H100: at the serving slice's prefill shape (B 8, Hq 9,
// Hkv 3, S 512, d 64, causal, bf16) q, k, v and o are 12.6 MB against 2.4 GFLOP
// of causal work, so the memory side of the roofline is the larger one
// (about 3.8 us at 3.35 TB/s against 2.4 us at 989 TFLOP/s).  The design keeps
// every intermediate on chip: one block per (q tile, head, batch) reads its q
// tile once, streams k/v tiles through shared memory, and writes o once; scores
// and probabilities live in registers and never touch device memory.  Tiles
// that the mask empties entirely (above the causal diagonal, before the sliding
// window, past k_len) are never loaded.
//
// Two routes by input type:
//  * bf16: tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//    The scores are scaled in f32 after the product, where the reference scales
//    q in f32 before it; the probabilities are rounded to bf16 for the P.V
//    product, where the reference multiplies f32 by f32.  Both differences sit
//    far inside the bf16 output's own rounding.
//  * f32: plain FMA on the CUDA cores, all in f32 like the reference (bf16
//    tensor cores would lose the f32 inputs' precision).
// Statistics (m, l) and the output accumulator are f32 on both routes; the
// output is cast to the input type.  Ragged Sq and Sk are handled by masked
// loads (zero rows) and masked stores, not by padding in device memory.
//
// The row logsumexp for the backward (csrc/flash_attention_bwd.cu): given a
// non-null `lse` (B, Hq, Sq) f32 buffer, each valid query row also writes
// m + log(max(l, 1e-30)), the logsumexp of its scaled, masked scores (m the
// running maximum, l the running sum of exp(s - m)).  With a null pointer the
// kernel does exactly what it did without this output.
//
// Simple first: no TMA, wgmma, cp.async pipelining or warp specialisation yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, Hq, Sq) contiguous, or null
  int B, Hq, Hkv, Sq, Sk;
  // element strides of the (B, H, S, d) views; the d stride is 1
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal;
  int window;  // 0: no window
  int k_len;   // 0 <= k_len <= Sk
  float scale;
};

__device__ __forceinline__ bool key_valid(const Params& p, int r, int c) {
  bool ok = c < p.k_len;
  if (p.causal) ok = ok && r >= c;
  if (p.window > 0) ok = ok && (r - c) < p.window;
  return ok;
}

// Key tiles [t0, t1) that hold at least one valid key for some row of the
// q tile starting at q0 with bq rows.
__device__ __forceinline__ void key_tile_range(const Params& p, int q0, int bq,
                                               int bk, int& t0, int& t1) {
  int kend = p.k_len;
  if (p.causal) kend = min(kend, q0 + bq);
  t1 = (kend + bk - 1) / bk;
  t0 = 0;
  if (p.window > 0) {
    const int kmin = q0 - p.window + 1;  // first key the first row can see
    if (kmin > 0) t0 = kmin / bk;
  }
}

// ---------------------------------------------------------------------------
// bf16 route: mma.sync tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaBQ = 64;   // query rows per block: 4 warps x 16 rows
constexpr int kMmaBK = 64;   // keys per tile
constexpr int kMmaThreads = 128;

template <int D>
struct MmaTile {
  static constexpr int LD = D + 8;  // smem row stride (bf16): 16-byte pad
  static constexpr int SMEM = (kMmaBQ + 2 * kMmaBK) * LD * 2;
};

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
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

// rows [row0, row0 + ROWS) of a (S, D) bf16 slab with row stride ss into smem
// with row stride LD; rows at or past `limit` are zero.  16-byte loads.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long ss, int row0,
                                               int limit) {
  constexpr int LD = MmaTile<D>::LD;
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += kMmaThreads) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * ss + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_bf16(Params p) {
  constexpr int LD = MmaTile<D>::LD;
  constexpr int KD = D / 16;       // k steps of the q.k product
  constexpr int NS = kMmaBK / 8;   // 8-key column tiles of the scores
  constexpr int NO = D / 8;        // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kMmaBQ * LD;
  __nv_bfloat16* v_s = k_s + kMmaBK * LD;

  const int q0 = blockIdx.x * kMmaBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  load_tile_bf16<D, kMmaBQ>(q_s, qg, p.q_ss, q0, p.Sq);
  __syncthreads();

  // This warp's 16 query rows as mma A fragments.
  uint32_t qf[KD][4];
  {
    const __nv_bfloat16* qw = q_s + warp * 16 * LD;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qf[kk][0] = ld_pair(qw + g * LD + kk * 16 + 2 * t);
      qf[kk][1] = ld_pair(qw + (g + 8) * LD + kk * 16 + 2 * t);
      qf[kk][2] = ld_pair(qw + g * LD + kk * 16 + 8 + 2 * t);
      qf[kk][3] = ld_pair(qw + (g + 8) * LD + kk * 16 + 8 + 2 * t);
    }
  }

  float o_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    o_acc[n][0] = o_acc[n][1] = o_acc[n][2] = o_acc[n][3] = 0.f;
  // rows r0 (fragment elements 0, 1) and r0 + 8 (elements 2, 3)
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int r0 = q0 + warp * 16 + g;

  int t0, t1;
  key_tile_range(p, q0, kMmaBQ, kMmaBK, t0, t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * kMmaBK;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile_bf16<D, kMmaBK>(k_s, kg, p.k_ss, k0, p.Sk);
    load_tile_bf16<D, kMmaBK>(v_s, vg, p.v_ss, k0, p.Sk);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = k_s + (j * 8 + g) * LD;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        mma_16816(s[j], qf[kk], ld_pair(kr + kk * 16 + 2 * t),
                  ld_pair(kr + kk * 16 + 8 + 2 * t));
    }

    // scale, mask, online softmax
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + (e >> 1) * 8;
        const int c = k0 + j * 8 + 2 * t + (e & 1);
        const float x = s[j][e] * p.scale;
        s[j][e] = key_valid(p, r, c) ? x : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      corr[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_r[e >> 1]);
        l_r[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o_acc[n][0] *= corr[0];
      o_acc[n][1] *= corr[0];
      o_acc[n][2] *= corr[1];
      o_acc[n][3] *= corr[1];
    }

    // O += P V: the score accumulators are already laid out as A fragments
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_f32(s[2 * kk][0], s[2 * kk][1]),
          pack_f32(s[2 * kk][2], s[2 * kk][3]),
          pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr = v_s + (kk * 16 + 2 * t) * LD;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = n * 8 + g;
        const uint32_t b0 = pack_bf16(vr[col], vr[LD + col]);
        const uint32_t b1 = pack_bf16(vr[8 * LD + col], vr[9 * LD + col]);
        mma_16816(o_acc[n], a, b0, b1);
      }
    }
  }

  float l_tot[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_tot[i] = fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= p.Sq) continue;
    if (p.lse != nullptr && t == 0)
      p.lse[((long long)b * p.Hq + h) * p.Sq + r] = m_r[i] + logf(l_tot[i]);
    __nv_bfloat16* orow = og + r * p.o_ss;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float lo = o_acc[n][2 * i] / l_tot[i];
      const float hi = o_acc[n][2 * i + 1] / l_tot[i];
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(lo, hi);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 route: FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kSimtBQ = 32;  // query rows per block, 4 threads per row
constexpr int kSimtBK = 32;  // keys per tile
constexpr int kSimtThreads = 128;

template <int D>
struct SimtTile {
  // q_s [BQ][D+1], k_s [BK][D+1], v_s [BK][D], p_s [BQ][BK+1] floats
  static constexpr int SMEM =
      (kSimtBQ * (D + 1) + kSimtBK * (D + 1) + kSimtBK * D +
       kSimtBQ * (kSimtBK + 1)) * 4;
};

template <int D>
__global__ void __launch_bounds__(kSimtThreads) flash_fwd_f32(Params p) {
  constexpr int LQ = D + 1;
  constexpr int LP = kSimtBK + 1;
  constexpr int NC = D / 4;        // output columns per thread
  constexpr int NK = kSimtBK / 4;  // keys per thread per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + kSimtBQ * LQ;
  float* v_s = k_s + kSimtBK * LQ;
  float* p_s = v_s + kSimtBK * D;

  const int q0 = blockIdx.x * kSimtBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int row = threadIdx.x / 4;  // the 4 threads of a row share a warp
  const int sub = threadIdx.x % 4;
  const int r = q0 + row;

  // q is scaled in f32 before the product, as in the reference
  for (int i = threadIdx.x; i < kSimtBQ * D; i += kSimtThreads) {
    const int rr = i / D, c = i % D;
    q_s[rr * LQ + c] = q0 + rr < p.Sq ? qg[(q0 + rr) * p.q_ss + c] * p.scale : 0.f;
  }

  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  float m = kNegInf, l = 0.f;

  int t0, t1;
  key_tile_range(p, q0, kSimtBQ, kSimtBK, t0, t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * kSimtBK;
    __syncthreads();
    for (int i = threadIdx.x; i < kSimtBK * D; i += kSimtThreads) {
      const int rr = i / D, c = i % D;
      const bool in = k0 + rr < p.Sk;
      k_s[rr * LQ + c] = in ? kg[(k0 + rr) * p.k_ss + c] : 0.f;
      v_s[rr * D + c] = in ? vg[(k0 + rr) * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[NK];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int key = sub + 4 * j;
      float x = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) x += q_s[row * LQ + d] * k_s[key * LQ + d];
      s[j] = key_valid(p, r, k0 + key) ? x : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    m = m_new;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      s[j] = expf(s[j] - m);
      ps += s[j];
      p_s[row * LP + sub + 4 * j] = s[j];
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l = l * corr + ps;
    __syncwarp();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = sub + 4 * c;
      float a = 0.f;
#pragma unroll 8
      for (int key = 0; key < kSimtBK; ++key)
        a += p_s[row * LP + key] * v_s[key * D + col];
      acc[c] = acc[c] * corr + a;
    }
  }

  if (r < p.Sq) {
    const float lt = fmaxf(l, 1e-30f);
    if (p.lse != nullptr && sub == 0)
      p.lse[((long long)b * p.Hq + h) * p.Sq + r] = m + logf(lt);
#pragma unroll
    for (int c = 0; c < NC; ++c) og[r * p.o_ss + sub + 4 * c] = acc[c] / lt;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem,
                   cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  d: 32, 64, 112 or 128.  lse: (B, Hq, Sq) f32
// or null.  Returns the CUDA error code of the launch (0 on success); the
// kernel runs on `stream` and nothing is synchronised here.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        float* lse, int dtype, int B, int Hq, int Hkv, int Sq, int Sk,
                        int d, long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh, long long o_ss,
                        int causal, int window, int k_len, float scale,
                        void* stream) {
  const Params p{q,    k,    v,    o,    lse,  B,    Hq,   Hkv,    Sq,     Sk,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,   v_sh,   v_ss,
                 o_sb, o_sh, o_ss, causal, window, k_len, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid((Sq + kMmaBQ - 1) / kMmaBQ, Hq, B);
    switch (d) {
      case 32: return launch(flash_fwd_bf16<32>, grid, kMmaThreads, MmaTile<32>::SMEM, st, p);
      case 64: return launch(flash_fwd_bf16<64>, grid, kMmaThreads, MmaTile<64>::SMEM, st, p);
      case 112: return launch(flash_fwd_bf16<112>, grid, kMmaThreads, MmaTile<112>::SMEM, st, p);
      case 128: return launch(flash_fwd_bf16<128>, grid, kMmaThreads, MmaTile<128>::SMEM, st, p);
    }
  } else if (dtype == 0) {
    const dim3 grid((Sq + kSimtBQ - 1) / kSimtBQ, Hq, B);
    switch (d) {
      case 32: return launch(flash_fwd_f32<32>, grid, kSimtThreads, SimtTile<32>::SMEM, st, p);
      case 64: return launch(flash_fwd_f32<64>, grid, kSimtThreads, SimtTile<64>::SMEM, st, p);
      case 112: return launch(flash_fwd_f32<112>, grid, kSimtThreads, SimtTile<112>::SMEM, st, p);
      case 128: return launch(flash_fwd_f32<128>, grid, kSimtThreads, SimtTile<128>::SMEM, st, p);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
