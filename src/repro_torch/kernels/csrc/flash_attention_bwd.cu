// Flash-attention backward for Hopper (sm_90a), with a plain C interface that
// kernels/flash_attention.py loads through ctypes.
//
// The reference has no counterpart: its Pallas kernel
// (src/repro/kernels/flash_attention.py::_flash_kernel) is forward-only and
// JAX differentiates the plain attention instead.  The port trains through
// its forward kernel (csrc/flash_attention.cu), so autograd needs this one.
// It computes the gradients of o = softmax(scale * q k^T + mask) v for q
// (B, Hq, Sq, d) and k, v (B, Hkv, Sk, d), with the forward's masks (causal or
// bidirectional, a sliding window, a k_len limit on the keys) and GQA (kv head
// = h / (Hq / Hkv)).  Given the forward's output o, the incoming dO and the
// forward's row logsumexp (B, Hq, Sq), three passes:
//
//  1. flash_bwd_delta: D = rowsum(dO * O) per query row, f32;
//  2. flash_bwd_dkdv: one block per (key tile, kv head, batch) recomputes
//     P = exp(scale * q k^T - lse) (0 where masked) tile by tile, and sums
//     dV = P^T dO and dK = scale * dS^T Q with dS = P * (dO V^T - D) over the
//     query tiles that see its keys and over the Hq / Hkv query heads of its
//     kv head.  One block owns each dK, dV tile, so there are no atomics and
//     the sums run in one fixed order: results repeat bit for bit.
//  3. flash_bwd_dq: one block per (query tile, q head, batch) sums
//     dQ = scale * dS K over the key tiles its rows see.
//
// Outputs dq, dk, dv are f32 and contiguous; the wrapper casts them to the
// input type.  A query row with no valid key has no defined forward output
// and none here either (the tests have none).
//
// What bounds it on an H100: at the training shape (B 2, Hq 9, Hkv 3, S 512,
// d 64, causal, bf16) the inputs and outputs are about 6 MB against 2.5 GFLOP
// of causal work (five products of 2 * d operations per valid (q, k) pair), so
// the tensor cores bound it (about 2.5 us at 989 TFLOP/s, against 1.8 us for
// the bytes).  The design keeps P and dS on chip: scores, probabilities and
// their gradients live in registers (bf16) or shared memory (f32) and never
// touch device memory; each block reads its own tile once and streams the
// other side's tiles through shared memory.  Two routes by input type:
//  * bf16: tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate),
//    P and dS rounded to bf16 for the products that take them, as the
//    forward rounds P;
//  * f32: plain FMA on the CUDA cores, all in f32, q scaled before the
//    product as in the reference.
//
// Simple first: no TMA, wgmma, cp.async pipelining or warp specialisation,
// and fragments are read from shared memory on every use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, Hq, Sq)
  float* delta;      // (B, Hq, Sq), written by pass 1
  float* dq;         // (B, Hq, Sq, d)
  float* dk;         // (B, Hkv, Sk, d)
  float* dv;         // (B, Hkv, Sk, d)
  int B, Hq, Hkv, Sq, Sk;
  // element strides of the (B, H, S, d) views; the d stride is 1
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  int causal;
  int window;  // 0: no window
  int k_len;   // 0 <= k_len <= Sk
  float scale;
};

__device__ __forceinline__ bool pair_valid(const Params& p, int r, int c) {
  bool ok = r < p.Sq && c < p.k_len;
  if (p.causal) ok = ok && r >= c;
  if (p.window > 0) ok = ok && (r - c) < p.window;
  return ok;
}

// Key tiles [t0, t1) holding a valid key for some row of the query tile at q0.
__device__ __forceinline__ void key_tile_range(const Params& p, int q0, int bq,
                                               int bk, int& t0, int& t1) {
  int kend = p.k_len;
  if (p.causal) kend = min(kend, q0 + bq);
  t1 = (kend + bk - 1) / bk;
  t0 = 0;
  if (p.window > 0) {
    const int kmin = q0 - p.window + 1;
    if (kmin > 0) t0 = kmin / bk;
  }
}

// Query tiles [t0, t1) holding a valid row for some key of the key tile at k0.
__device__ __forceinline__ void query_tile_range(const Params& p, int k0, int bk,
                                                 int bq, int& t0, int& t1) {
  int qlo = p.causal ? k0 : 0;
  int qhi = p.Sq;
  if (p.window > 0) qhi = min(qhi, k0 + bk - 1 + p.window);
  if (k0 >= p.k_len) qhi = qlo;
  t0 = qlo / bq;
  t1 = qhi > qlo ? (qhi + bq - 1) / bq : t0;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// Pass 1: D = rowsum(dO * O), one warp per query row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta(Params p, int d) {
  const int r = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  if (r >= p.Sq) return;
  const T* orow = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh + r * p.o_ss;
  const T* drow = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh + r * p.do_ss;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc += to_float(orow[c]) * to_float(drow[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[((long long)b * p.Hq + h) * p.Sq + r] = acc;
}

// ---------------------------------------------------------------------------
// bf16 route: mma.sync tensor cores, 64-row tiles, one warp per 16 rows
// ---------------------------------------------------------------------------

constexpr int kMmaB = 64;  // rows of every tile (queries or keys)

template <int D>
struct MmaTile {
  static constexpr int LD = D + 8;                            // bf16 row stride
  static constexpr int SMEM = 4 * kMmaB * LD * 2 + 2 * kMmaB * 4;
};

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
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

// rows [row0, row0 + 64) of a (S, D) bf16 slab with row stride ss into smem
// with row stride LD; rows at or past `limit` are zero.  16-byte loads.
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long ss, int row0, int limit) {
  constexpr int LD = MmaTile<D>::LD;
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < kMmaB * VPR; i += kThreads) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * ss + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// acc[j] (16 rows x 64 cols, 8 column tiles) = A rows (this warp's 16 rows of
// a_s) times the 64 rows of b_s, over D: the q.k product shape.
template <int D>
__device__ __forceinline__ void rows_times_rows(float (&acc)[kMmaB / 8][4],
                                                const __nv_bfloat16* a_s,
                                                const __nv_bfloat16* b_s, int g, int t) {
  constexpr int LD = MmaTile<D>::LD;
#pragma unroll
  for (int j = 0; j < kMmaB / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t a[4] = {ld_pair(a_s + g * LD + kk * 16 + 2 * t),
                           ld_pair(a_s + (g + 8) * LD + kk * 16 + 2 * t),
                           ld_pair(a_s + g * LD + kk * 16 + 8 + 2 * t),
                           ld_pair(a_s + (g + 8) * LD + kk * 16 + 8 + 2 * t)};
#pragma unroll
    for (int j = 0; j < kMmaB / 8; ++j) {
      const __nv_bfloat16* br = b_s + (j * 8 + g) * LD;
      mma_16816(acc[j], a, ld_pair(br + kk * 16 + 2 * t), ld_pair(br + kk * 16 + 8 + 2 * t));
    }
  }
}

// out[n] (16 rows x D) += X (16 x 64, the f32 accumulators x rounded to bf16
// as A fragments) times the 64 rows of m_s (64 x D): the p.v product shape.
template <int D>
__device__ __forceinline__ void acc_times_rows(float (&out)[D / 8][4],
                                               const float (&x)[kMmaB / 8][4],
                                               const __nv_bfloat16* m_s, int g, int t) {
  constexpr int LD = MmaTile<D>::LD;
#pragma unroll
  for (int kk = 0; kk < kMmaB / 16; ++kk) {
    const uint32_t a[4] = {pack_f32(x[2 * kk][0], x[2 * kk][1]),
                           pack_f32(x[2 * kk][2], x[2 * kk][3]),
                           pack_f32(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_f32(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    const __nv_bfloat16* mr = m_s + (kk * 16 + 2 * t) * LD;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + g;
      mma_16816(out[n], a, pack_bf16(mr[col], mr[LD + col]),
                pack_bf16(mr[8 * LD + col], mr[9 * LD + col]));
    }
  }
}

template <int D>
__device__ void dkdv_bf16(const Params& p, unsigned char* smem) {
  constexpr int LD = MmaTile<D>::LD;
  constexpr int NS = kMmaB / 8;
  constexpr int NO = D / 8;
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + kMmaB * LD;
  __nv_bfloat16* q_s = v_s + kMmaB * LD;
  __nv_bfloat16* do_s = q_s + kMmaB * LD;
  float* lse_s = reinterpret_cast<float*>(do_s + kMmaB * LD);
  float* dl_s = lse_s + kMmaB;

  const int k0 = blockIdx.x * kMmaB;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = k0 + warp * 16 + g;  // this thread's key rows c0 and c0 + 8

  load_tile_bf16<D>(k_s, static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh,
                    p.k_ss, k0, p.Sk);
  load_tile_bf16<D>(v_s, static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh,
                    p.v_ss, k0, p.Sk);

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  int t0, t1;
  query_tile_range(p, k0, kMmaB, kMmaB, t0, t1);
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
    for (int qt = t0; qt < t1; ++qt) {
      const int q0 = qt * kMmaB;
      __syncthreads();  // every warp is done with the previous tiles
      load_tile_bf16<D>(q_s, static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh,
                        p.q_ss, q0, p.Sq);
      load_tile_bf16<D>(do_s,
                        static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh,
                        p.do_ss, q0, p.Sq);
      for (int i = threadIdx.x; i < kMmaB; i += kThreads) {
        const bool in = q0 + i < p.Sq;
        lse_s[i] = in ? p.lse[row_base + q0 + i] : 0.f;
        dl_s[i] = in ? p.delta[row_base + q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 queries
      float s[NS][4], dp[NS][4];
      rows_times_rows<D>(s, k_s + warp * 16 * LD, q_s, g, t);
      rows_times_rows<D>(dp, v_s + warp * 16 * LD, do_s, g, t);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * t + (e & 1);
          const bool ok = pair_valid(p, q0 + qi, c0 + (e >> 1) * 8);
          const float pv = ok ? expf(s[j][e] * p.scale - lse_s[qi]) : 0.f;
          s[j][e] = pv;
          dp[j][e] = pv * (dp[j][e] - dl_s[qi]);
        }
      }
      acc_times_rows<D>(dv, s, do_s, g, t);   // dV += P^T dO
      acc_times_rows<D>(dk, dp, q_s, g, t);   // dK += dS^T Q
    }
  }

  const long long kv_base = ((long long)b * p.Hkv + hk) * p.Sk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = c0 + 8 * i;
    if (c >= p.Sk) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const long long off = (kv_base + c) * D + n * 8 + 2 * t;
      p.dk[off] = dk[n][2 * i] * p.scale;
      p.dk[off + 1] = dk[n][2 * i + 1] * p.scale;
      p.dv[off] = dv[n][2 * i];
      p.dv[off + 1] = dv[n][2 * i + 1];
    }
  }
}

template <int D>
__device__ void dq_bf16(const Params& p, unsigned char* smem) {
  constexpr int LD = MmaTile<D>::LD;
  constexpr int NS = kMmaB / 8;
  constexpr int NO = D / 8;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* do_s = q_s + kMmaB * LD;
  __nv_bfloat16* k_s = do_s + kMmaB * LD;
  __nv_bfloat16* v_s = k_s + kMmaB * LD;

  const int q0 = blockIdx.x * kMmaB;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g;  // this thread's query rows r0 and r0 + 8
  const long long row_base = ((long long)b * p.Hq + h) * p.Sq;

  load_tile_bf16<D>(q_s, static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh,
                    p.q_ss, q0, p.Sq);
  load_tile_bf16<D>(do_s, static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh,
                    p.do_ss, q0, p.Sq);
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = r0 + 8 * i < p.Sq;
    lse_r[i] = in ? p.lse[row_base + r0 + 8 * i] : 0.f;
    dl_r[i] = in ? p.delta[row_base + r0 + 8 * i] : 0.f;
  }
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  int t0, t1;
  key_tile_range(p, q0, kMmaB, kMmaB, t0, t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * kMmaB;
    __syncthreads();
    load_tile_bf16<D>(k_s, kg, p.k_ss, k0, p.Sk);
    load_tile_bf16<D>(v_s, vg, p.v_ss, k0, p.Sk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x 64 keys
    float s[NS][4], dp[NS][4];
    rows_times_rows<D>(s, q_s + warp * 16 * LD, k_s, g, t);
    rows_times_rows<D>(dp, do_s + warp * 16 * LD, v_s, g, t);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const bool ok = pair_valid(p, r0 + 8 * i, k0 + j * 8 + 2 * t + (e & 1));
        const float pv = ok ? expf(s[j][e] * p.scale - lse_r[i]) : 0.f;
        dp[j][e] = pv * (dp[j][e] - dl_r[i]);
      }
    }
    acc_times_rows<D>(dq, dp, k_s, g, t);   // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= p.Sq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const long long off = (row_base + r) * D + n * 8 + 2 * t;
      p.dq[off] = dq[n][2 * i] * p.scale;
      p.dq[off + 1] = dq[n][2 * i + 1] * p.scale;
    }
  }
}

// ---------------------------------------------------------------------------
// f32 route: FMA on the CUDA cores, 32-row tiles, 4 threads per row
// ---------------------------------------------------------------------------

constexpr int kSimtB = 32;  // rows of every tile (queries or keys)

template <int D>
struct SimtTile {
  static constexpr int LQ = D + 1;
  static constexpr int LP = kSimtB + 1;
  // four (32, D+1) tiles, two (32, 33) score tiles, lse and D of 32 rows
  static constexpr int SMEM = (4 * kSimtB * LQ + 2 * kSimtB * LP + 2 * kSimtB) * 4;
};

// rows [row0, row0 + 32) of a (S, D) f32 slab into smem with row stride D + 1,
// times `mul`; rows at or past `limit` are zero.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long ss,
                                              int row0, int limit, float mul) {
  for (int i = threadIdx.x; i < kSimtB * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = row0 + r < limit ? src[(row0 + r) * ss + c] * mul : 0.f;
  }
}

template <int D>
__device__ void dkdv_f32(const Params& p, unsigned char* smem) {
  constexpr int LQ = SimtTile<D>::LQ, LP = SimtTile<D>::LP;
  constexpr int NC = D / 4;
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + kSimtB * LQ;
  float* q_s = v_s + kSimtB * LQ;   // q scaled, as in the reference
  float* do_s = q_s + kSimtB * LQ;
  float* p_s = do_s + kSimtB * LQ;  // [key][query]
  float* ds_s = p_s + kSimtB * LP;
  float* lse_s = ds_s + kSimtB * LP;
  float* dl_s = lse_s + kSimtB;

  const int k0 = blockIdx.x * kSimtB;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int row = threadIdx.x / 4, sub = threadIdx.x % 4;  // a row's 4 threads share a warp
  const int c = k0 + row;

  load_tile_f32<D>(k_s, static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss,
                   k0, p.Sk, 1.f);
  load_tile_f32<D>(v_s, static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss,
                   k0, p.Sk, 1.f);
  float dk[NC], dv[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dk[i] = dv[i] = 0.f;

  int t0, t1;
  query_tile_range(p, k0, kSimtB, kSimtB, t0, t1);
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
    for (int qt = t0; qt < t1; ++qt) {
      const int q0 = qt * kSimtB;
      __syncthreads();
      load_tile_f32<D>(q_s, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
                       q0, p.Sq, p.scale);
      load_tile_f32<D>(do_s, static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh,
                       p.do_ss, q0, p.Sq, 1.f);
      for (int i = threadIdx.x; i < kSimtB; i += kThreads) {
        const bool in = q0 + i < p.Sq;
        lse_s[i] = in ? p.lse[row_base + q0 + i] : 0.f;
        dl_s[i] = in ? p.delta[row_base + q0 + i] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < kSimtB / 4; ++jj) {
        const int j = sub + 4 * jj;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          s += q_s[j * LQ + d] * k_s[row * LQ + d];
          dp += do_s[j * LQ + d] * v_s[row * LQ + d];
        }
        const float pv = pair_valid(p, q0 + j, c) ? expf(s - lse_s[j]) : 0.f;
        p_s[row * LP + j] = pv;
        ds_s[row * LP + j] = pv * (dp - dl_s[j]);
      }
      __syncwarp();
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int col = sub + 4 * cc;
        float a = 0.f, bk = 0.f;
#pragma unroll 8
        for (int j = 0; j < kSimtB; ++j) {
          a += p_s[row * LP + j] * do_s[j * LQ + col];
          bk += ds_s[row * LP + j] * q_s[j * LQ + col];
        }
        dv[cc] += a;
        dk[cc] += bk;  // q_s holds scale * q
      }
    }
  }
  if (c < p.Sk) {
    const long long off = (((long long)b * p.Hkv + hk) * p.Sk + c) * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      p.dk[off + sub + 4 * cc] = dk[cc];
      p.dv[off + sub + 4 * cc] = dv[cc];
    }
  }
}

template <int D>
__device__ void dq_f32(const Params& p, unsigned char* smem) {
  constexpr int LQ = SimtTile<D>::LQ, LP = SimtTile<D>::LP;
  constexpr int NC = D / 4;
  float* q_s = reinterpret_cast<float*>(smem);  // q scaled
  float* do_s = q_s + kSimtB * LQ;
  float* k_s = do_s + kSimtB * LQ;
  float* v_s = k_s + kSimtB * LQ;
  float* ds_s = v_s + kSimtB * LQ;  // [query][key]

  const int q0 = blockIdx.x * kSimtB;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int row = threadIdx.x / 4, sub = threadIdx.x % 4;
  const int r = q0 + row;
  const long long row_base = ((long long)b * p.Hq + h) * p.Sq;

  load_tile_f32<D>(q_s, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, q0,
                   p.Sq, p.scale);
  load_tile_f32<D>(do_s, static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh,
                   p.do_ss, q0, p.Sq, 1.f);
  const float lse = r < p.Sq ? p.lse[row_base + r] : 0.f;
  const float dl = r < p.Sq ? p.delta[row_base + r] : 0.f;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float dq[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dq[i] = 0.f;

  int t0, t1;
  key_tile_range(p, q0, kSimtB, kSimtB, t0, t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * kSimtB;
    __syncthreads();
    load_tile_f32<D>(k_s, kg, p.k_ss, k0, p.Sk, 1.f);
    load_tile_f32<D>(v_s, vg, p.v_ss, k0, p.Sk, 1.f);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kSimtB / 4; ++jj) {
      const int key = sub + 4 * jj;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s += q_s[row * LQ + d] * k_s[key * LQ + d];
        dp += do_s[row * LQ + d] * v_s[key * LQ + d];
      }
      const float pv = pair_valid(p, r, k0 + key) ? expf(s - lse) : 0.f;
      ds_s[row * LP + key] = pv * (dp - dl);
    }
    __syncwarp();
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int col = sub + 4 * cc;
      float a = 0.f;
#pragma unroll 8
      for (int key = 0; key < kSimtB; ++key) a += ds_s[row * LP + key] * k_s[key * LQ + col];
      dq[cc] += a;
    }
  }
  if (r < p.Sq) {
    const long long off = (row_base + r) * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) p.dq[off + sub + 4 * cc] = dq[cc] * p.scale;
  }
}

// ---------------------------------------------------------------------------
// Passes 2 and 3, one kernel each over both routes
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    dkdv_bf16<D>(p, smem_raw);
  else
    dkdv_f32<D>(p, smem_raw);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    dq_bf16<D>(p, smem_raw);
  else
    dq_f32<D>(p, smem_raw);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, cudaStream_t stream,
                   const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run(const Params& p, cudaStream_t st) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int tile = kBf16 ? kMmaB : kSimtB;
  constexpr int smem = kBf16 ? MmaTile<D>::SMEM : SimtTile<D>::SMEM;
  flash_bwd_delta<T><<<dim3((p.Sq + 7) / 8, p.Hq, p.B), 256, 0, st>>>(p, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch(flash_bwd_dkdv<T, D>, dim3((p.Sk + tile - 1) / tile, p.Hkv, p.B), kThreads,
               smem, st, p);
  if (err != cudaSuccess) return err;
  return launch(flash_bwd_dq<T, D>, dim3((p.Sq + tile - 1) / tile, p.Hq, p.B), kThreads, smem,
                st, p);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout alike).  d: 32, 64 or
// 128.  lse: the forward's (B, Hq, Sq) f32; delta: (B, Hq, Sq) f32 scratch;
// dq (B, Hq, Sq, d), dk and dv (B, Hkv, Sk, d): f32, contiguous.  Launches the
// three passes on `stream` in order; returns the first CUDA error (0 on
// success).  Nothing is synchronised here.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* delta, float* dq,
                        float* dk, float* dv, int dtype, int B, int Hq, int Hkv, int Sq,
                        int Sk, int d, long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                        long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                        long long o_ss, long long do_sb, long long do_sh, long long do_ss,
                        int causal, int window, int k_len, float scale, void* stream) {
  const Params p{q,    k,    v,    o,    dout, lse,  delta, dq,    dk,    dv,     B,
                 Hq,   Hkv,  Sq,   Sk,   q_sb, q_sh, q_ss,  k_sb,  k_sh,  k_ss,   v_sb,
                 v_sh, v_ss, o_sb, o_sh, o_ss, do_sb, do_sh, do_ss, causal, window, k_len,
                 scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (d) {
      case 32: return run<__nv_bfloat16, 32>(p, st);
      case 64: return run<__nv_bfloat16, 64>(p, st);
      case 128: return run<__nv_bfloat16, 128>(p, st);
    }
  } else if (dtype == 0) {
    switch (d) {
      case 32: return run<float, 32>(p, st);
      case 64: return run<float, 64>(p, st);
      case 128: return run<float, 128>(p, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
