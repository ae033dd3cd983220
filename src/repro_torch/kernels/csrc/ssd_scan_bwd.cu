// The backward of the Mamba2 SSD chunked scan (csrc/ssd_scan.cu) for Hopper
// (sm_90a), with a plain C interface that kernels/ssd_scan.py loads through
// ctypes.
//
// Replaces no TPU kernel: src/repro/kernels/ssd_scan.py::_ssd_kernel is
// forward-only, and the reference trains through the VJP of its jnp scan
// (repro/models/ssm.py:67-92).  The port's model reaches the forward kernel
// (ROADMAP C1), so training needs this backward.  Per (b, h), chunk c and
// positions i, j of the chunk, with a the within-chunk cumsum of dt*A, a_Q
// its last element, xdt_j = dt_j x_j, s the state entering the chunk (the
// forward kernel writes it), g = dL/d(the state after the chunk) (g of the
// last chunk = dfin, zeros when none is given), L_ij = exp(a_i - a_j) for
// j <= i, S = C B^T, dS = dy xdt^T, M = L o dS, T = L o S and W = S o M:
//
//   g_prev = exp(a_Q) g + sum_i exp(a_i) C_i (x) dy_i        (d init = g_{-1})
//   dC_i   = sum_j M_ij B_j + exp(a_i) s dy_i
//   dB_j   = sum_i M_ij C_i + exp(a_Q - a_j) g xdt_j
//   dxdt_j = sum_i T_ij dy_i + exp(a_Q - a_j) g^T B_j;  dx = dt dxdt, ddt = x . dxdt
//   da     = rowsum(W) - colsum(W) + exp(a_i) dy_i . (C_i s) - u_j,
//            u_j = exp(a_Q - a_j) B_j . (g xdt_j); at a_Q also exp(a_Q) <g, s> + sum_j u_j
//
// (kernels/ref.py::ssd_scan_bwd is the same arithmetic in plain torch.)
// Two routes, chosen by the inputs' type alone, as the forward's are.
//
// * f32 (x, B and C float32), three launches, each simple:
//   (a) ssd_bwd_state, one block per (b, h): the reverse state scan.  The
//       chunks are walked from last to first with g (N x P f32) in shared
//       memory, as the forward carries s; g is written for every chunk
//       ((B, H, nc, N, P) f32) before the chunk's update, then d init.
//   (b) ssd_bwd_chunk, one block per (b, h, c), where the parallelism is:
//       B H nc blocks.  Tiles of 32 chunk rows of C, B (row stride N + 1), dy
//       and xdt (P + 1) come into shared memory as f32; a thread owns rows
//       ty + 8k (k < 4) and columns tx + 32m of each product, its sums in
//       registers.  Pass 1 walks the row tiles i and, for each, the column
//       tiles j <= i: S and dS (4 values a thread), M into shared memory, the
//       row and column sums of W, and dC_i += M B_j.  Pass 2 walks the column
//       tiles j and the row tiles i >= j: dB_j += M^T C_i, dxdt_j += T^T dy_i.
//       The state terms read s (pass 1) and g (pass 2) from a copy in shared
//       memory (row stride P + 1): read from device memory, lanes that take
//       one column of 32 rows touch 32 lines a load.  dx is
//       written in x's type, ddt and da in f32, dB and dC per head in f32
//       ((B, H, S, N)).
//   (c) ssd_bwd_head_sum: dB and dC of each group summed over its H / G heads
//       in ascending head order in f32, rounded once to the inputs' type.
//   It multiplies in f32 on the CUDA cores, as the TPU kernel multiplies in
//   f32 (the f32 checks and reference runs).
//
// * bf16 (x, B and C bfloat16: training's path), on tensor cores,
//   mma.sync.m16n8k16 with f32 accumulators, four launches:
//   (a) ssd_bwd_delta_mma, one block per (b, h, c): the chunk's own term of
//       the state scan, D_c = C^T (exp(a) o dy) (N x P), written where the
//       combine reads it (gst[c - 1]; d init for c = 0);
//   (a') ssd_bwd_combine, one thread per (b, h, n, p): g_{c-1} = exp(a_Q) g_c
//       + D_c, serial over the chunks from the last (g of the last = dfin),
//       in place in gst: the scan's products run for every chunk at once;
//   (b) ssd_bwd_chunk_mma, one block per (b, h, c), grouped in thread-block
//       clusters of ck heads of one group (ck the largest power of two up to
//       8 dividing H / G): every gradient of the chunk.  The chunk's rows
//       (up to 256) stay in shared memory whole: pass 1 holds B and x (bf16)
//       and s, pass 2 C (bf16), dy (f32) and g, so a warp needs no block
//       barrier between its blocks of 16 x 16.  Warps own strips of 16 rows,
//       in phases of 8 strips, warp w strip w (w < 4) or 11 - w of the
//       phase, so the two warps of a scheduler split the causal work evenly.
//       Pass 1 (rows i): S = C B^T and dS = dy x^T in registers, M and W
//       formed in the accumulators, whose layout is the A operand's (the
//       FlashAttention 2 pattern), dC_i += M B_j and the row sums of W.
//       Pass 2 (rows j): S^T = B C^T and dS^T = x dy^T computed again (the
//       transposed products keep every operand in its A or B layout, so M
//       and T never go to shared memory), dB_j += M^T C_i, dxdt_j += T^T dy_i
//       and the column sums of W as row sums.  The state terms start each
//       strip's sums: dC from exp(a_i) s dy_i, dB and dxdt from g.
//       dB and dC are summed over the cluster's heads through distributed
//       shared memory, 64 rows a round, each block a share of the rows, the
//       heads in ascending order, into one f32 partial per cluster
//       ((B, H / ck, S, N)): no per-head f32 plane.  dx in x's type, ddt and
//       da in f32, as the f32 route.
//   (c) ssd_bwd_group_sum: each group's partials summed in ascending order,
//       rounded once to bf16.
//   C, B and x are exact bf16 operands; each f32 operand goes in as three
//   bf16 parts, v = hi + mid + lo (split_pair, as csrc/ssd_scan.cu): one MMA
//   per part against an exact operand, and six of the nine part products
//   where both sides are f32 (T^T dy and dy s^T; the three left out are
//   below 2^-24 of the product), so every product keeps f32-level accuracy.
//   Shapes: P 16, 32 or 64, N a multiple of 8 up to 128, a chunk of at most
//   256 rows, within 227 KB of shared memory a block (213 KB at N 128, P 64,
//   Q 256: one block an SM).
//
// Every sum has a fixed order (warp shuffles by xor, per-warp partials
// added by one thread, a fixed head order, the cluster's heads in rank
// order), and there are no atomics, so a result is bit-equal on repeat.
// Exponents are masked before the exp: exp(a_i - a_j) only where j <= i < Q,
// never exp(a_i) exp(-a_j), which overflows at the full models' random init
// (the pre-softplus dt has std 6 to 17, so a falls by hundreds within a
// chunk); exp(a_i), exp(a_Q) and exp(a_Q - a_j) are at most 1.  The da sums
// cancel (the row and column sums of the same W): both are accumulated in
// f32, each in its own array.
//
// What bounds it on an H100: at mamba2-2.7b's training shape (B 1, H 80,
// S 4096, Q 256, P 64, N 128) the function moves about 0.22 GB (0.065 ms at
// 3.35 TB/s); the f32 route's chunks launch does about 67 GFLOP, 1.0 ms at
// the f32 peak of the CUDA cores.  The bf16 route issues about 240 GFLOP of
// MMAs (the split parts, S and dS twice, the state terms; 42752 m16n8k16 a
// block of the chunks' launch), 0.24 ms at the bf16 tensor-core peak: eight
// warps an SM (255 registers each) leave it bound by the latency of its
// dependent products, not by the tensor cores' issue or by memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: ty = tid / 32, tx = tid % 32
constexpr int kT = 32;         // chunk rows per tile
constexpr int kMaxNC = 4;      // column groups of 32 over N: N <= 128
constexpr int kMaxSmem = 232448;

struct Params {
  const void* x;        // (b, h, s, p), p dense
  const float* dt;      // (b, h, s)
  const float* a;       // (b, h, s): the within-chunk cumsum of dt * A
  const void* bm;       // (b, g, s, n), n dense
  const void* cm;       // (b, g, s, n), n dense
  const float* dy;      // (b, h, s, p), p dense
  const float* states;  // (B, H, nc, N, P): the state entering each chunk
  const float* dfin;    // (B, H, N, P) or null (zeros)
  float* gst;           // (B, H, nc, N, P): dL/d(the state after each chunk)
  float* dinit;         // (B, H, N, P) or null
  void* dx;             // (B, S, H, P) in x's type, or null
  float* ddt;           // (B, S, H), or null
  float* da;            // (B, S, H), or null
  float* dbh;           // (B, planes, S, N) f32: per head (f32), per cluster (bf16); or null
  float* dch;           // the same for dC
  void* db;             // (B, S, G, N) in the inputs' type, or null
  void* dc;             // (B, S, G, N), or null
  int dtype, B, H, G, N, P, Q, nc;
  long long x_sb, x_sh, x_ss, dt_sb, dt_sh, dt_ss, a_sb, a_sh, a_ss;
  long long b_sb, b_sg, b_ss, c_sb, c_sg, c_ss, dy_sb, dy_sh, dy_ss;
  // set by the launch on the bf16 route: heads a cluster sums, and whether
  // every row of B and C, of x, of dy starts 16-byte aligned
  int ck, vec_bc, vec_x, vec_dy;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [row0, row0 + kT) of a chunk's (Q, K) slab (row stride `ss`, columns
// dense) into dst (row stride K + 1) as f32, row i times scale[i] when
// `scale` is given; zero past Q.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ss, int row0,
                                          int Q, int K, const float* scale) {
  for (int e = threadIdx.x; e < kT * K; e += kThreads) {
    const int r = e / K, k = e - r * K, i = row0 + r;
    float v = 0.f;
    if (i < Q) {
      v = to_f32(src[i * ss + k]);
      if (scale != nullptr) v *= scale[i];
    }
    dst[r * (K + 1) + k] = v;
  }
}

// ---------------------------------------------------------------------------
// (a) the reverse state scan
// ---------------------------------------------------------------------------

__host__ __device__ inline long long state_smem_floats(int N, int P) {
  return (long long)N * P + (long long)kT * (N + 1) + (long long)kT * (P + 1) + kT;
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads) ssd_bwd_state(Params p) {
  constexpr int PC = (P + 31) / 32;
  const int N = p.N, Q = p.Q;
  extern __shared__ __align__(16) float smem[];
  float* g = smem;                  // N x P
  float* c_t = g + N * P;           // kT x (N + 1): C rows
  float* y_t = c_t + kT * (N + 1);  // kT x (P + 1): exp(a_i) dy_i
  float* e_s = y_t + kT * (P + 1);  // exp(a_i) of the tile's rows
  const int h = blockIdx.x, b = blockIdx.y, grp = h / (p.H / p.G);
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
  const long long NP = (long long)N * P;
  const long long bh = (long long)b * p.H + h;
  const T* cg = static_cast<const T*>(p.cm) + b * p.c_sb + grp * p.c_sg;
  const float* dyg = p.dy + b * p.dy_sb + h * p.dy_sh;
  const float* ag = p.a + b * p.a_sb + h * p.a_sh;

  for (int e = threadIdx.x; e < NP; e += kThreads)
    g[e] = p.dfin != nullptr ? p.dfin[bh * NP + e] : 0.f;
  for (int c = p.nc - 1; c >= 0; --c) {
    const long long s0 = (long long)c * Q;
    __syncthreads();  // g is whole
    float* out = p.gst + (bh * p.nc + c) * NP;
    const float keep = expf(ag[(s0 + Q - 1) * p.a_ss]);
    for (int e = threadIdx.x; e < NP; e += kThreads) {
      out[e] = g[e];
      g[e] *= keep;
    }
    for (int i0 = 0; i0 < Q; i0 += kT) {
      __syncthreads();  // g scaled; the previous tile is consumed
      for (int r = threadIdx.x; r < kT; r += kThreads)
        e_s[r] = i0 + r < Q ? expf(ag[(s0 + i0 + r) * p.a_ss]) : 0.f;
      load_tile<T>(c_t, cg + s0 * p.c_ss, p.c_ss, i0, Q, N, nullptr);
      __syncthreads();
      for (int e = threadIdx.x; e < kT * P; e += kThreads) {
        const int r = e / P, col = e % P, i = i0 + r;
        y_t[r * (P + 1) + col] = i < Q ? dyg[(s0 + i) * p.dy_ss + col] * e_s[r] : 0.f;
      }
      __syncthreads();
      // g[n][col] += sum_r C[r][n] y[r][col]; this thread owns n = n0 + ty + 8k
      for (int n0 = 0; n0 < N; n0 += 32) {
        float acc[4][PC] = {};
        for (int r = 0; r < kT; ++r) {
          float cv[4], yv[PC];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int n = n0 + ty + 8 * k;
            cv[k] = n < N ? c_t[r * (N + 1) + n] : 0.f;
          }
#pragma unroll
          for (int m = 0; m < PC; ++m) {
            const int col = tx + 32 * m;
            yv[m] = col < P ? y_t[r * (P + 1) + col] : 0.f;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int m = 0; m < PC; ++m) acc[k][m] += cv[k] * yv[m];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int n = n0 + ty + 8 * k;
#pragma unroll
          for (int m = 0; m < PC; ++m) {
            const int col = tx + 32 * m;
            if (n < N && col < P) g[n * P + col] += acc[k][m];
          }
        }
      }
    }
  }
  __syncthreads();
  if (p.dinit != nullptr)
    for (int e = threadIdx.x; e < NP; e += kThreads) p.dinit[bh * NP + e] = g[e];
}

// ---------------------------------------------------------------------------
// (b) the gradients within each chunk
// ---------------------------------------------------------------------------

// Shared floats of launch (b): a, dt, the two da arrays and u of the chunk
// (rows rounded up to kT), the C, B (N + 1) and dy, xdt (P + 1) tiles, M and
// T (kT + 1), the column sums' per-warp partials and a block sum's, and the
// state (s in pass 1, g in pass 2; row stride P + 1, so that lanes reading
// one column of consecutive rows, or one row, hit distinct banks).
struct ChunkLayout {
  int rows;
  long long a, dt, dar, dac, u, ci, bj, yi, xj, mt, tt, ws, red, sg, total;
};

__host__ __device__ inline ChunkLayout chunk_layout(int N, int P, int Q) {
  ChunkLayout l;
  l.rows = (Q + kT - 1) / kT * kT;
  l.a = 0;
  l.dt = l.a + l.rows;
  l.dar = l.dt + l.rows;
  l.dac = l.dar + l.rows;
  l.u = l.dac + l.rows;
  l.ci = l.u + l.rows;
  l.bj = l.ci + (long long)kT * (N + 1);
  l.yi = l.bj + (long long)kT * (N + 1);
  l.xj = l.yi + (long long)kT * (P + 1);
  l.mt = l.xj + (long long)kT * (P + 1);
  l.tt = l.mt + kT * (kT + 1);
  l.ws = l.tt + kT * (kT + 1);
  l.red = l.ws + 8 * kT;
  l.sg = l.red + 8;
  l.total = l.sg + (long long)N * (P + 1);
  return l;
}

// The sum of every thread's v, in a fixed order (lanes by xor, then the
// warps in order); every thread gets it.  `red` holds 8 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  return t;
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk(Params p) {
  constexpr int PC = (P + 31) / 32;
  constexpr int LY = P + 1;
  const int N = p.N, Q = p.Q, LN = N + 1;
  const int NC = (N + 31) / 32;
  const int nt = (Q + kT - 1) / kT;
  const ChunkLayout l = chunk_layout(N, P, Q);
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem + l.a;
  float* dt_s = smem + l.dt;
  float* dar = smem + l.dar;  // row sums of W, the inter-chunk term, - u
  float* dac = smem + l.dac;  // column sums of W
  float* u_s = smem + l.u;
  float* ci = smem + l.ci;
  float* bj = smem + l.bj;
  float* yi = smem + l.yi;
  float* xj = smem + l.xj;
  float* mt = smem + l.mt;
  float* tt = smem + l.tt;
  float* ws = smem + l.ws;
  float* red = smem + l.red;
  float* sg = smem + l.sg;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (p.H / p.G);
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
  const long long s0 = (long long)c * Q;
  const long long S = (long long)p.nc * Q;
  const long long NP = (long long)N * P;
  const long long bh = (long long)b * p.H + h;
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh + s0 * p.x_ss;
  const T* bg = static_cast<const T*>(p.bm) + b * p.b_sb + grp * p.b_sg + s0 * p.b_ss;
  const T* cg = static_cast<const T*>(p.cm) + b * p.c_sb + grp * p.c_sg + s0 * p.c_ss;
  const float* dyg = p.dy + b * p.dy_sb + h * p.dy_sh + s0 * p.dy_ss;
  const float* st = p.states + (bh * p.nc + c) * NP;  // s: the state entering the chunk
  const float* gs = p.gst + (bh * p.nc + c) * NP;     // g: dL/d(the state after it)

  for (int i = threadIdx.x; i < l.rows; i += kThreads) {
    a_s[i] = i < Q ? p.a[b * p.a_sb + h * p.a_sh + (s0 + i) * p.a_ss] : 0.f;
    dt_s[i] = i < Q ? p.dt[b * p.dt_sb + h * p.dt_sh + (s0 + i) * p.dt_ss] : 0.f;
    dar[i] = dac[i] = u_s[i] = 0.f;
  }
  for (long long e = threadIdx.x; e < NP; e += kThreads) sg[(e / P) * LY + e % P] = st[e];
  __syncthreads();
  const float a_last = a_s[Q - 1];

  // S (rows i0 + ty + 8k, column j0 + tx) and M = L o dS, T = L o S, W = S o M
  // of the tile pair whose tiles are in ci / yi and bj / xj; M and T into
  // shared memory (rows i, columns j).  Pass 1 (`sums`) adds the row sums of
  // W into dar and leaves the column sums in ws (per warp) for the caller to
  // add; pass 2 recomputes the pair for T and takes no sums.
  auto tile_pair = [&](int i0, int j0, bool sums) {
    float sv[4] = {}, dv[4] = {};
    for (int n = 0; n < N; ++n) {
      const float bv = bj[tx * LN + n];
#pragma unroll
      for (int k = 0; k < 4; ++k) sv[k] += ci[(ty + 8 * k) * LN + n] * bv;
    }
    for (int q = 0; q < P; ++q) {
      const float xv = xj[tx * LY + q];
#pragma unroll
      for (int k = 0; k < 4; ++k) dv[k] += yi[(ty + 8 * k) * LY + q] * xv;
    }
    const int j = j0 + tx;
    float colsum = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = ty + 8 * k, i = i0 + r;
      const bool ok = j <= i && i < Q;
      const float diff = ok ? a_s[i] - a_s[j] : 0.f;  // masked before the exp
      const float L = ok ? expf(diff) : 0.f;
      const float m = L * dv[k];
      const float w = sv[k] * m;
      mt[r * (kT + 1) + tx] = m;
      if (sums) {
        const float rs = warp_sum(w);
        if (tx == 0 && i < Q) dar[i] += rs;
        colsum += w;
      } else {
        tt[r * (kT + 1) + tx] = L * sv[k];
      }
    }
    if (sums) ws[ty * kT + tx] = colsum;
  };

  // ---- pass 1: the row tiles; dC and the row-side terms of da ----
  for (int it = 0; it < nt; ++it) {
    const int i0 = it * kT;
    __syncthreads();  // earlier readers of ci / yi are done
    load_tile<T>(ci, cg, p.c_ss, i0, Q, N, nullptr);
    load_tile<float>(yi, dyg, p.dy_ss, i0, Q, P, nullptr);
    __syncthreads();
    // the inter-chunk term: r_i = s dy_i, dC_i = exp(a_i) r_i,
    // da_i += exp(a_i) C_i . r_i
    float acc[4][kMaxNC];
#pragma unroll
    for (int m = 0; m < kMaxNC; ++m) {
      const int n = tx + 32 * m;
      float rv[4] = {};
      if (m < NC && n < N)
        for (int q = 0; q < P; ++q) {
          const float sv = sg[n * LY + q];
#pragma unroll
          for (int k = 0; k < 4; ++k) rv[k] += sv * yi[(ty + 8 * k) * LY + q];
        }
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k][m] = rv[k];  // r_i for now
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = ty + 8 * k, i = i0 + r;
      const float e = i < Q ? expf(a_s[i]) : 0.f;
      float dot = 0.f;
#pragma unroll
      for (int m = 0; m < kMaxNC; ++m) {
        const int n = tx + 32 * m;
        if (m < NC && n < N) dot += ci[r * LN + n] * acc[k][m];
        acc[k][m] *= e;
      }
      dot = warp_sum(dot);
      if (tx == 0 && i < Q) dar[i] += e * dot;
    }
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();  // earlier readers of bj / xj / mt / ws are done
      load_tile<T>(bj, bg, p.b_ss, j0, Q, N, nullptr);
      load_tile<T>(xj, xg, p.x_ss, j0, Q, P, dt_s);
      __syncthreads();
      tile_pair(i0, j0, true);
      __syncthreads();
      if (ty == 0 && j0 + tx < Q) {
        float cs = 0.f;
#pragma unroll
        for (int w = 0; w < kThreads / 32; ++w) cs += ws[w * kT + tx];
        dac[j0 + tx] += cs;
      }
      // dC_i += sum_j M_ij B_j
      for (int jj = 0; jj < kT; ++jj) {
        float mv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) mv[k] = mt[(ty + 8 * k) * (kT + 1) + jj];
#pragma unroll
        for (int m = 0; m < kMaxNC; ++m) {
          const int n = tx + 32 * m;
          if (m < NC) {
            const float bv = n < N ? bj[jj * LN + n] : 0.f;
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[k][m] += mv[k] * bv;
          }
        }
      }
    }
    if (p.dch != nullptr) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + ty + 8 * k;
        if (i >= Q) continue;
        float* row = p.dch + (bh * S + s0 + i) * N;
#pragma unroll
        for (int m = 0; m < kMaxNC; ++m) {
          const int n = tx + 32 * m;
          if (m < NC && n < N) row[n] = acc[k][m];
        }
      }
    }
  }

  // ---- pass 2: the column tiles; dB, dxdt and the state's terms of da ----
  __syncthreads();  // pass 1 is done with s
  float gsum = 0.f;  // <g, s>, this thread's part
  for (long long e = threadIdx.x; e < NP; e += kThreads) {
    const float gv = __ldg(gs + e);
    gsum += gv * sg[(e / P) * LY + e % P];
    sg[(e / P) * LY + e % P] = gv;
  }
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * kT;
    __syncthreads();  // earlier readers of bj / xj are done
    load_tile<T>(bj, bg, p.b_ss, j0, Q, N, nullptr);
    load_tile<T>(xj, xg, p.x_ss, j0, Q, P, dt_s);
    __syncthreads();
    // the state's terms: gx_j = g xdt_j, dB_j = ed_j gx_j, dxdt_j = ed_j g^T B_j,
    // u_j = ed_j B_j . gx_j (ed_j = exp(a_Q - a_j))
    float accb[4][kMaxNC], accx[4][PC];
#pragma unroll
    for (int m = 0; m < kMaxNC; ++m) {
      const int n = tx + 32 * m;
      float gx[4] = {};
      if (m < NC && n < N)
        for (int q = 0; q < P; ++q) {
          const float gv = sg[n * LY + q];
#pragma unroll
          for (int k = 0; k < 4; ++k) gx[k] += gv * xj[(ty + 8 * k) * LY + q];
        }
#pragma unroll
      for (int k = 0; k < 4; ++k) accb[k][m] = gx[k];  // gx_j for now
    }
#pragma unroll
    for (int m = 0; m < PC; ++m) {
      const int q = tx + 32 * m;
      float v[4] = {};
      if (q < P)
        for (int n = 0; n < N; ++n) {
          const float gv = sg[n * LY + q];
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] += bj[(ty + 8 * k) * LN + n] * gv;
        }
#pragma unroll
      for (int k = 0; k < 4; ++k) accx[k][m] = v[k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = ty + 8 * k, j = j0 + r;
      const float ed = j < Q ? expf(a_last - a_s[j]) : 0.f;
      float dot = 0.f;
#pragma unroll
      for (int m = 0; m < kMaxNC; ++m) {
        const int n = tx + 32 * m;
        if (m < NC && n < N) dot += bj[r * LN + n] * accb[k][m];
        accb[k][m] *= ed;
      }
      dot = warp_sum(dot);
      if (tx == 0 && j < Q) u_s[j] = ed * dot;
#pragma unroll
      for (int m = 0; m < PC; ++m) accx[k][m] *= ed;
    }
    for (int it = jt; it < nt; ++it) {
      const int i0 = it * kT;
      __syncthreads();  // earlier readers of ci / yi / mt / tt are done
      load_tile<T>(ci, cg, p.c_ss, i0, Q, N, nullptr);
      load_tile<float>(yi, dyg, p.dy_ss, i0, Q, P, nullptr);
      __syncthreads();
      tile_pair(i0, j0, false);
      __syncthreads();
      // dB_j += sum_i M_ij C_i;  dxdt_j += sum_i T_ij dy_i (this thread's rows
      // are now the columns j0 + ty + 8k)
      for (int ii = 0; ii < kT; ++ii) {
        float mv[4], tv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          mv[k] = mt[ii * (kT + 1) + ty + 8 * k];
          tv[k] = tt[ii * (kT + 1) + ty + 8 * k];
        }
#pragma unroll
        for (int m = 0; m < kMaxNC; ++m) {
          const int n = tx + 32 * m;
          if (m < NC) {
            const float cv = n < N ? ci[ii * LN + n] : 0.f;
#pragma unroll
            for (int k = 0; k < 4; ++k) accb[k][m] += mv[k] * cv;
          }
        }
#pragma unroll
        for (int m = 0; m < PC; ++m) {
          const int q = tx + 32 * m;
          const float yv = q < P ? yi[ii * LY + q] : 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) accx[k][m] += tv[k] * yv;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + ty + 8 * k;
      const bool live = j < Q;  // the same for every lane of the warp
      if (p.dbh != nullptr && live) {
        float* row = p.dbh + (bh * S + s0 + j) * N;
#pragma unroll
        for (int m = 0; m < kMaxNC; ++m) {
          const int n = tx + 32 * m;
          if (m < NC && n < N) row[n] = accb[k][m];
        }
      }
      // dx = dt dxdt in x's type; ddt = x . dxdt
      const T* xr = xg + (live ? j : 0) * p.x_ss;
      float dot = 0.f;
#pragma unroll
      for (int m = 0; m < PC; ++m) {
        const int q = tx + 32 * m;
        if (q < P && live) {
          dot += to_f32(xr[q]) * accx[k][m];
          if (p.dx != nullptr)
            from_f32(dt_s[j] * accx[k][m],
                     static_cast<T*>(p.dx) + ((b * S + s0 + j) * p.H + h) * P + q);
        }
      }
      dot = warp_sum(dot);
      if (tx == 0 && live && p.ddt != nullptr) p.ddt[(b * S + s0 + j) * p.H + h] = dot;
    }
  }

  // ---- da: the two sums' difference, u, and the terms at a_Q ----
  if (p.da == nullptr) return;
  gsum = block_sum(gsum, red);  // its syncs also order the u_s and dar writes before the reads
  float usum = 0.f;
  for (int i = threadIdx.x; i < Q; i += kThreads) usum += u_s[i];
  usum = block_sum(usum, red);
  for (int i = threadIdx.x; i < Q; i += kThreads) {
    float v = dar[i] - dac[i] - u_s[i];
    if (i == Q - 1) v += expf(a_last) * gsum + usum;
    p.da[(b * S + s0 + i) * p.H + h] = v;
  }
}

// ---------------------------------------------------------------------------
// (c) the head sum of dB and dC
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_head_sum(Params p) {
  const long long S = (long long)p.nc * p.Q;
  const long long total = (long long)p.B * S * p.G * p.N;
  const float* src = blockIdx.y == 0 ? p.dbh : p.dch;
  T* dst = static_cast<T*>(blockIdx.y == 0 ? p.db : p.dc);
  if (src == nullptr || dst == nullptr) return;
  const int hg = p.H / p.G;
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kThreads) {
    const int n = e % p.N;
    const long long rest = e / p.N;
    const int g = rest % p.G;
    const long long bs = rest / p.G;
    const long long s = bs % S, b = bs / S;
    float v = 0.f;
    for (int h = g * hg; h < (g + 1) * hg; ++h) v += src[((b * p.H + h) * S + s) * p.N + n];
    from_f32(v, dst + e);
  }
}

// ---------------------------------------------------------------------------
// bf16 route: mma.sync tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaMaxQ = 256;        // chunk rows a block holds: 16 strips of 16
constexpr int kMaxKs = 8;            // k-steps of 16 over the state: N <= 128
constexpr int kMaxNt = 2 * kMaxKs;   // n-tiles of 8 over the state
constexpr int kStageRows = 64;       // rows of dB or dC one cluster round sums
constexpr int kMaxCluster = 8;       // the portable cluster size

// Heads of one group that a cluster sums: the largest power of two up to 8
// that divides H / G (a round's 64 rows split evenly over the cluster).
__host__ __device__ inline int head_cluster(int H, int G) {
  const int hg = H / G;
  int k = 1;
  while (2 * k <= kMaxCluster && hg % (2 * k) == 0) k *= 2;
  return k;
}

// Shared memory of ssd_bwd_chunk_mma, in bytes from the start.  Always: a,
// dt, the two da arrays and u of the chunk (R = Q rounded up to 16 rows),
// the block sums, the state (s in pass 1, g in pass 2; N rounded up to 16
// rows of P + 4 f32), the cluster's stage (64 rows of NP + 4 f32).  Then,
// in one place, pass 1's B and x (bf16, rows of NP + 8 and P + 8) or pass
// 2's C (bf16) and dy (f32, rows of P + 4).  Rows are padded by 16 bytes, so
// the eight rows of an ldmatrix fall on distinct banks.
struct MmaLayout {
  int R, NP, ldb, ldx, ldy, lds, ldst;
  long long a, dt, dar, dac, u, red, state, stage, bt, xt, ct, dyt, total;
};

__host__ __device__ inline MmaLayout mma_layout(int N, int P, int Q) {
  MmaLayout l;
  l.R = (Q + 15) / 16 * 16;
  l.NP = (N + 15) / 16 * 16;
  l.ldb = l.NP + 8;
  l.ldx = P + 8;
  l.ldy = P + 4;
  l.lds = P + 4;
  l.ldst = l.NP + 4;
  l.a = 0;
  l.dt = l.a + 4LL * l.R;
  l.dar = l.dt + 4LL * l.R;
  l.dac = l.dar + 4LL * l.R;
  l.u = l.dac + 4LL * l.R;
  l.red = l.u + 4LL * l.R;
  l.state = l.red + 4LL * 16;
  l.stage = l.state + 4LL * l.NP * l.lds;
  const long long shared = l.stage + 4LL * kStageRows * l.ldst;
  l.bt = shared;
  l.xt = l.bt + 2LL * l.R * l.ldb;
  l.ct = shared;
  l.dyt = l.ct + 2LL * l.R * l.ldb;
  const long long end1 = l.xt + 2LL * l.R * l.ldx, end2 = l.dyt + 4LL * l.R * l.ldy;
  l.total = end1 > end2 ? end1 : end2;
  return l;
}

// Shared memory of ssd_bwd_delta_mma: C (bf16, rows of NP + 8), exp(a_i)
// dy_i (f32, rows of P + 4) and exp(a_i), R rows each.
struct DeltaLayout {
  int R, NP, ldb, ldy;
  long long ct, ey, ea, total;
};

__host__ __device__ inline DeltaLayout delta_layout(int N, int P, int Q) {
  DeltaLayout l;
  l.R = (Q + 15) / 16 * 16;
  l.NP = (N + 15) / 16 * 16;
  l.ldb = l.NP + 8;
  l.ldy = P + 4;
  l.ct = 0;
  l.ey = l.ct + 2LL * l.R * l.ldb;
  l.ea = l.ey + 4LL * l.R * l.ldy;
  l.total = l.ea + 4LL * l.R;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; only the first src_bytes are read, the rest
// is zero-filled (src_bytes 0: a zero vector, nothing read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.  Not
// volatile, so the compiler may interleave independent products.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two f32 values packed in a bf16x2 word (the lower address first).
__device__ __forceinline__ float2 unpack_bf2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// A pair of f32 values as three bf16x2 words, hi + mid + lo: each part the
// round-to-nearest of what the parts before it leave (the differences are
// exact in f32), so the parts hold 24 bits of each value.
struct Split3 {
  uint32_t hi, mid, lo;
};

__device__ __forceinline__ Split3 split_pair(float v0, float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = v0 - hf.x, r1 = v1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 lw = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  return {bf2_bits(h), bf2_bits(m), bf2_bits(lw)};
}

// An f32 A operand (16 x 16) in three parts.
struct SplitA {
  uint32_t hi[4], mid[4], lo[4];
};

__device__ __forceinline__ SplitA split_a(const Split3& q0, const Split3& q1, const Split3& q2,
                                          const Split3& q3) {
  return {{q0.hi, q1.hi, q2.hi, q3.hi}, {q0.mid, q1.mid, q2.mid, q3.mid},
          {q0.lo, q1.lo, q2.lo, q3.lo}};
}

// Two n-tiles of accumulators (16 x 16) as the A operand of the next
// product, split: their layout is the A fragment's.
__device__ __forceinline__ SplitA split_acc(const float (&s)[2][4]) {
  return split_a(split_pair(s[0][0], s[0][1]), split_pair(s[0][2], s[0][3]),
                 split_pair(s[1][0], s[1][1]), split_pair(s[1][2], s[1][3]));
}

// d += (hi + mid + lo) * b: an f32 A operand against an exact bf16 B.
__device__ __forceinline__ void mma_asplit(float (&d)[4], const SplitA& a, uint32_t b0,
                                           uint32_t b1) {
  mma_16816(d, a.hi, b0, b1);
  mma_16816(d, a.mid, b0, b1);
  mma_16816(d, a.lo, b0, b1);
}

// d += a * (hi + mid + lo): an exact bf16 A against an f32 B (b0, b1 the
// fragment's two words, each split).
__device__ __forceinline__ void mma_bsplit(float (&d)[4], const uint32_t (&a)[4],
                                           const Split3& b0, const Split3& b1) {
  mma_16816(d, a, b0.hi, b1.hi);
  mma_16816(d, a, b0.mid, b1.mid);
  mma_16816(d, a, b0.lo, b1.lo);
}

// d += a * b with both operands f32 in three parts: six of the nine part
// products (hi hi, hi mid, mid hi, hi lo, lo hi, mid mid); the three left
// out (mid lo, lo mid, lo lo) are below 2^-24 of the product.
__device__ __forceinline__ void mma_split6(float (&d)[4], const SplitA& a, const Split3& b0,
                                           const Split3& b1) {
  mma_16816(d, a.hi, b0.hi, b1.hi);
  mma_16816(d, a.hi, b0.mid, b1.mid);
  mma_16816(d, a.mid, b0.hi, b1.hi);
  mma_16816(d, a.hi, b0.lo, b1.lo);
  mma_16816(d, a.lo, b0.hi, b1.hi);
  mma_16816(d, a.mid, b0.mid, b1.mid);
}

// Two bf16 values at p (p[0] in the low half), as one 32-bit load where the
// rows are aligned (vec), else two 16-bit loads.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const unsigned int*>(p));
  const unsigned short lo = __ldg(reinterpret_cast<const unsigned short*>(p));
  const unsigned short hi = __ldg(reinterpret_cast<const unsigned short*>(p) + 1);
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// The A fragments of rows r0, r0 + 8 of a bf16 (rows, K) slab (row stride
// ss) over k-steps [0, ks_n): zero past `rows` and past K.
template <int KS>
__device__ __forceinline__ void load_a_bf16(uint32_t (&f)[KS][4], const __nv_bfloat16* src,
                                            long long ss, int r0, int rows, int K, int ks_n,
                                            bool vec) {
  const int t = threadIdx.x % 4;
  const __nv_bfloat16* ra = src + (long long)r0 * ss;
  const __nv_bfloat16* rb = ra + 8 * ss;
  const bool va = r0 < rows, vb = r0 + 8 < rows;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    f[ks][0] = f[ks][1] = f[ks][2] = f[ks][3] = 0u;
    if (ks >= ks_n) continue;
    const int k0 = 16 * ks + 2 * t;
    if (va && k0 < K) f[ks][0] = ld_pair(ra + k0, vec);
    if (vb && k0 < K) f[ks][1] = ld_pair(rb + k0, vec);
    if (va && k0 + 8 < K) f[ks][2] = ld_pair(ra + k0 + 8, vec);
    if (vb && k0 + 8 < K) f[ks][3] = ld_pair(rb + k0 + 8, vec);
  }
}

// Rows [0, R) of a chunk's (Q, K) bf16 slab (row stride ss) into dst (row
// stride ld, KP columns): zero past Q and past K (a multiple of 8).  16-byte
// cp.async where every row is aligned (vec), else element copies.
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst, int ld,
                                               const __nv_bfloat16* src, long long ss, int R,
                                               int Q, int K, int KP, bool vec) {
  const int per = KP / 8;
  for (int v = threadIdx.x; v < R * per; v += kThreads) {
    const int r = v / per, c8 = (v - r * per) * 8;
    const bool ok = r < Q && c8 < K;
    __nv_bfloat16* d = dst + r * ld + c8;
    const __nv_bfloat16* s = src + r * ss + c8;
    if (vec) {
      cp_async16(d, ok ? s : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = ok ? s[e] : __float2bfloat16(0.f);
    }
  }
}

// Rows [0, R) of a chunk's (Q, P) f32 slab into dst (row stride ld), zero
// past Q; cp.async where aligned.
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const float* src, long long ss,
                                              int R, int Q, int P, bool vec) {
  const int per = P / 4;
  for (int v = threadIdx.x; v < R * per; v += kThreads) {
    const int r = v / per, c4 = (v - r * per) * 4;
    const bool ok = r < Q;
    float* d = dst + r * ld + c4;
    const float* s = src + r * ss + c4;
    if (vec) {
      cp_async16(d, ok ? s : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = ok ? __ldg(s + e) : 0.f;
    }
  }
}

// Where L_ij = exp(a_i - a_j) is taken (the exponent masked before the exp).
__device__ __forceinline__ bool causal(int i, int j, int Q) { return j <= i && i < Q; }

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives (release) and waits
// (acquire): shared-memory writes before it are seen by the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// 16 rows x NT n-tiles of accumulators into the stage (row stride ld).
__device__ __forceinline__ void stage_rows(float* stage, int ld, int row, const float (&acc)[kMaxNt][4],
                                           int NT) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float* r0 = stage + (row + g) * ld + 2 * t;
  float* r1 = r0 + 8 * ld;
#pragma unroll
  for (int nt = 0; nt < kMaxNt; ++nt) {
    if (nt >= NT) continue;
    *reinterpret_cast<float2*>(r0 + 8 * nt) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(r1 + 8 * nt) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// The cluster's stages (64 rows each, the chunk's rows row0 ..) summed over
// its blocks in rank order, this block's share of the rows, into `part`
// (row stride N, rows of the chunk; rows past Q skipped).  Every block's
// value is loaded before the first add, so the remote loads overlap.
__device__ __forceinline__ void cluster_sum(float* part, const float* stage, int ld, int row0,
                                            int Q, int N, unsigned ck) {
  const unsigned rank = cluster_rank();
  const int share = kStageRows / static_cast<int>(ck);
  const uint32_t base = smem_addr(stage);
  for (int e = threadIdx.x; e < share * N; e += kThreads) {
    const int rr = static_cast<int>(rank) * share + e / N, n = e % N, i = row0 + rr;
    if (i >= Q) continue;
    const uint32_t addr = base + 4u * static_cast<uint32_t>(rr * ld + n);
    const int heads = static_cast<int>(ck);
    float r[kMaxCluster];
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) r[k] = k < heads ? ld_cluster_f32(addr, k) : 0.f;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < heads) v += r[k];
    part[(long long)i * N + n] = v;
  }
}

// (a) The chunk's own term of the state scan, D_c = C^T (exp(a) o dy): warp
// w owns state rows [16 (w % WM), + 16) (WM = NP / 16) and the n-tiles of P
// with nt % (8 / WM) == w / WM; A = C^T by ldmatrix.trans, B = exp(a_i) dy_i
// read from shared memory and split.  D_c goes where the combine reads it:
// gst[c - 1], or d init for c = 0 (not computed without an initial state).
template <int P>
__global__ void __launch_bounds__(kThreads) ssd_bwd_delta_mma(Params p) {
  constexpr int PT = P / 8;
  const int N = p.N, Q = p.Q;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  if (c == 0 && p.dinit == nullptr) return;
  const DeltaLayout l = delta_layout(N, P, Q);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ct = reinterpret_cast<__nv_bfloat16*>(smem_raw + l.ct);
  float* ey = reinterpret_cast<float*>(smem_raw + l.ey);
  float* ea = reinterpret_cast<float*>(smem_raw + l.ea);
  const long long s0 = (long long)c * Q;
  const long long bh = (long long)b * p.H + h;
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(p.cm) + b * p.c_sb +
                            (h / (p.H / p.G)) * p.c_sg + s0 * p.c_ss;
  const float* dyg = p.dy + b * p.dy_sb + h * p.dy_sh + s0 * p.dy_ss;
  load_rows_bf16(ct, l.ldb, cg, p.c_ss, l.R, Q, N, l.NP, p.vec_bc);
  load_rows_f32(ey, l.ldy, dyg, p.dy_ss, l.R, Q, P, p.vec_dy);
  cp_async_commit();
  for (int i = threadIdx.x; i < l.R; i += kThreads)
    ea[i] = i < Q ? expf(p.a[b * p.a_sb + h * p.a_sh + (s0 + i) * p.a_ss]) : 0.f;
  cp_async_wait_all();
  __syncthreads();
  for (int e = 4 * threadIdx.x; e < l.R * P; e += 4 * kThreads) {  // exp(a_i) dy_i
    const int r = e / P;
    float4* q = reinterpret_cast<float4*>(ey + r * l.ldy + e % P);
    const float4 v = *q;
    *q = make_float4(ea[r] * v.x, ea[r] * v.y, ea[r] * v.z, ea[r] * v.w);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int WM = l.NP / 16, WG = kThreads / 32 / WM;
  if (warp >= WM * WG) return;
  const int n0 = 16 * (warp % WM), mine = warp / WM;
  float acc[PT][4];
#pragma unroll
  for (int pt = 0; pt < PT; ++pt) acc[pt][0] = acc[pt][1] = acc[pt][2] = acc[pt][3] = 0.f;
  for (int ks = 0; ks < l.R / 16; ++ks) {
    uint32_t af[4];
    ldmatrix_x4_trans(af, ct + (16 * ks + (lane % 8) + (lane / 16) * 8) * l.ldb + n0 +
                              ((lane / 8) % 2) * 8);
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
      if (pt % WG != mine) continue;
      const float* q = ey + (16 * ks + 2 * t) * l.ldy + 8 * pt + g;
      mma_bsplit(acc[pt], af, split_pair(q[0], q[l.ldy]), split_pair(q[8 * l.ldy], q[9 * l.ldy]));
    }
  }
  const long long NPn = (long long)N * P;
  float* out = c > 0 ? p.gst + (bh * p.nc + c - 1) * NPn : p.dinit + bh * NPn;
#pragma unroll
  for (int pt = 0; pt < PT; ++pt) {
    if (pt % WG != mine) continue;
    const int col = 8 * pt + 2 * t, na = n0 + g, nb = na + 8;
    if (na < N) *reinterpret_cast<float2*>(out + na * P + col) = make_float2(acc[pt][0], acc[pt][1]);
    if (nb < N) *reinterpret_cast<float2*>(out + nb * P + col) = make_float2(acc[pt][2], acc[pt][3]);
  }
}

// (a') The reverse scan over the chunks' own terms, in place in gst:
// g_{nc-1} = dfin (or zeros), g_{c-1} = exp(a_Q of chunk c) g_c + D_c, and
// d init = exp(a_Q of chunk 0) g_0 + D_0; one thread per (b, h, n, p).
__global__ void __launch_bounds__(kThreads) ssd_bwd_combine(Params p) {
  const long long NPn = (long long)p.N * p.P, total = (long long)p.B * p.H * NPn;
  for (long long idx = blockIdx.x * (long long)kThreads + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * kThreads) {
    const long long bh = idx / NPn, e = idx - bh * NPn;
    const int b = static_cast<int>(bh / p.H), h = static_cast<int>(bh % p.H);
    const float* ag = p.a + b * p.a_sb + h * p.a_sh;
    float v = p.dfin != nullptr ? p.dfin[bh * NPn + e] : 0.f;
    float* gp = p.gst + bh * p.nc * NPn + e;
    gp[(p.nc - 1) * NPn] = v;
    for (int c = p.nc - 1; c >= 1; --c) {
      const float keep = expf(ag[((long long)c * p.Q + p.Q - 1) * p.a_ss]);
      v = keep * v + gp[(c - 1) * NPn];
      gp[(c - 1) * NPn] = v;
    }
    if (p.dinit != nullptr)
      p.dinit[bh * NPn + e] = expf(ag[(p.Q - 1) * p.a_ss]) * v + p.dinit[bh * NPn + e];
  }
}

// (b) Every gradient of one chunk of one head; the cluster sums dB and dC
// over its heads (the source's note).
template <int P>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_chunk_mma(Params p) {
  constexpr int KP = P / 16;  // k-steps over P
  constexpr int PT = P / 8;   // n-tiles over P
  const int N = p.N, Q = p.Q;
  const MmaLayout l = mma_layout(N, P, Q);
  const int KS = l.NP / 16, NT = l.NP / 8, nst = l.R / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* a_s = reinterpret_cast<float*>(smem_raw + l.a);
  float* dt_s = reinterpret_cast<float*>(smem_raw + l.dt);
  float* dar = reinterpret_cast<float*>(smem_raw + l.dar);  // row sums of W, the state term
  float* dac = reinterpret_cast<float*>(smem_raw + l.dac);  // column sums of W
  float* u_s = reinterpret_cast<float*>(smem_raw + l.u);
  float* red = reinterpret_cast<float*>(smem_raw + l.red);
  float* st_m = reinterpret_cast<float*>(smem_raw + l.state);
  float* stage = reinterpret_cast<float*>(smem_raw + l.stage);
  __nv_bfloat16* bt = reinterpret_cast<__nv_bfloat16*>(smem_raw + l.bt);
  __nv_bfloat16* xt = reinterpret_cast<__nv_bfloat16*>(smem_raw + l.xt);
  __nv_bfloat16* ct = reinterpret_cast<__nv_bfloat16*>(smem_raw + l.ct);
  float* dyt = reinterpret_cast<float*>(smem_raw + l.dyt);

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const unsigned ck = static_cast<unsigned>(p.ck);
  const int group = h / (p.H / p.G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const long long s0 = (long long)c * Q;
  const long long S = (long long)p.nc * Q;
  const long long NPn = (long long)N * P;
  const long long bh = (long long)b * p.H + h;
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(p.x) + b * p.x_sb + h * p.x_sh +
                            s0 * p.x_ss;
  const __nv_bfloat16* bg = static_cast<const __nv_bfloat16*>(p.bm) + b * p.b_sb +
                            group * p.b_sg + s0 * p.b_ss;
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(p.cm) + b * p.c_sb +
                            group * p.c_sg + s0 * p.c_ss;
  const float* dyg = p.dy + b * p.dy_sb + h * p.dy_sh + s0 * p.dy_ss;
  const long long part0 = (((long long)b * (p.H / p.ck) + h / p.ck) * S + s0) * N;
  float* dcp = p.dch != nullptr ? p.dch + part0 : nullptr;  // this cluster's partials
  float* dbp = p.dbh != nullptr ? p.dbh + part0 : nullptr;

  // ---- pass 1 (rows i): load a, dt, s, B and x ----
  for (int i = threadIdx.x; i < l.R; i += kThreads) {
    a_s[i] = i < Q ? p.a[b * p.a_sb + h * p.a_sh + (s0 + i) * p.a_ss] : 0.f;
    dt_s[i] = i < Q ? p.dt[b * p.dt_sb + h * p.dt_sh + (s0 + i) * p.dt_ss] : 0.f;
    dar[i] = dac[i] = u_s[i] = 0.f;
  }
  {
    const float* src = p.states + (bh * p.nc + c) * NPn;
    for (int e = 4 * threadIdx.x; e < l.NP * P; e += 4 * kThreads) {
      const int n = e / P, col = e % P;
      *reinterpret_cast<float4*>(st_m + n * l.lds + col) =
          n < N ? *reinterpret_cast<const float4*>(src + n * P + col)
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  load_rows_bf16(bt, l.ldb, bg, p.b_ss, l.R, Q, N, l.NP, p.vec_bc);
  load_rows_bf16(xt, l.ldx, xg, p.x_ss, l.R, Q, P, P, p.vec_x);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const float a_last = a_s[Q - 1];

  for (int m = 0; 8 * m < nst; ++m) {
    const int st = 8 * m + (warp < 4 ? warp : 11 - warp);
    float acc[kMaxNt][4];  // dC of the strip
#pragma unroll
    for (int nt = 0; nt < kMaxNt; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    if (st < nst) {
      const int i0 = 16 * st, ia = i0 + g, ib = ia + 8;
      const bool va = ia < Q, vb = ib < Q;
      uint32_t cf[kMaxKs][4];  // C's A fragments of the strip
      load_a_bf16<kMaxKs>(cf, cg, p.c_ss, ia, Q, N, KS, p.vec_bc);
      SplitA dya[KP];  // dy's, split
#pragma unroll
      for (int kp = 0; kp < KP; ++kp) {
        const float* ra = dyg + (long long)ia * p.dy_ss + 16 * kp + 2 * t;
        const float* rb = ra + 8 * p.dy_ss;
        const float z = 0.f;
        dya[kp] = split_a(split_pair(va ? __ldg(ra) : z, va ? __ldg(ra + 1) : z),
                          split_pair(vb ? __ldg(rb) : z, vb ? __ldg(rb + 1) : z),
                          split_pair(va ? __ldg(ra + 8) : z, va ? __ldg(ra + 9) : z),
                          split_pair(vb ? __ldg(rb + 8) : z, vb ? __ldg(rb + 9) : z));
      }
      // the state's term: r_i = s dy_i (both f32), dC_i = exp(a_i) r_i,
      // da_i += exp(a_i) C_i . r_i
#pragma unroll
      for (int nt = 0; nt < kMaxNt; ++nt) {
        if (nt >= NT) continue;
#pragma unroll
        for (int kp = 0; kp < KP; ++kp) {
          const float* sp = st_m + (8 * nt + g) * l.lds + 16 * kp + 2 * t;
          mma_split6(acc[nt], dya[kp], split_pair(sp[0], sp[1]), split_pair(sp[8], sp[9]));
        }
      }
      const float ai = a_s[ia], bi = a_s[ib];
      const float ea = va ? expf(ai) : 0.f, eb = vb ? expf(bi) : 0.f;
      float da_a = 0.f, da_b = 0.f;
#pragma unroll
      for (int nt = 0; nt < kMaxNt; ++nt) {
        if (nt >= NT) continue;
        const float2 ca = unpack_bf2(cf[nt / 2][(nt % 2) * 2]);
        const float2 cb = unpack_bf2(cf[nt / 2][(nt % 2) * 2 + 1]);
        da_a += ca.x * acc[nt][0] + ca.y * acc[nt][1];
        da_b += cb.x * acc[nt][2] + cb.y * acc[nt][3];
        acc[nt][0] *= ea;
        acc[nt][1] *= ea;
        acc[nt][2] *= eb;
        acc[nt][3] *= eb;
      }
      // the blocks of 16 columns at or left of the diagonal
      float rs_a = 0.f, rs_b = 0.f;
      for (int jb = 0; jb <= st; ++jb) {
        const int j0 = 16 * jb;
        float sc[2][4] = {}, ds[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < kMaxKs; ++ks) {  // S = C B^T
          if (ks >= KS) continue;
          uint32_t bb[4];
          ldmatrix_x4(bb, bt + (j0 + (lane % 8) + (lane / 16) * 8) * l.ldb + 16 * ks +
                              ((lane / 8) % 2) * 8);
          mma_16816(sc[0], cf[ks], bb[0], bb[1]);
          mma_16816(sc[1], cf[ks], bb[2], bb[3]);
        }
#pragma unroll
        for (int kp = 0; kp < KP; ++kp) {  // dy x^T
          uint32_t xb[4];
          ldmatrix_x4(xb, xt + (j0 + (lane % 8) + (lane / 16) * 8) * l.ldx + 16 * kp +
                              ((lane / 8) % 2) * 8);
          mma_asplit(ds[0], dya[kp], xb[0], xb[1]);
          mma_asplit(ds[1], dya[kp], xb[2], xb[3]);
        }
        // M = L o dt_j o (dy x^T) and W = S o M, the exponent masked first
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib;
            const int j = j0 + 8 * nn + 2 * t + (e & 1);
            const bool ok = causal(i, j, Q);
            const float diff = ok ? (e < 2 ? ai : bi) - a_s[j] : 0.f;
            const float mv = ok ? expf(diff) * dt_s[j] * ds[nn][e] : 0.f;
            (e < 2 ? rs_a : rs_b) += sc[nn][e] * mv;
            ds[nn][e] = mv;
          }
        }
        const SplitA ma = split_acc(ds);
#pragma unroll
        for (int np = 0; np < kMaxKs; ++np) {  // dC_i += M B_j
          if (np >= KS) continue;
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, bt + (j0 + (lane % 16)) * l.ldb + 16 * np + (lane / 16) * 8);
          mma_asplit(acc[2 * np], ma, bb[0], bb[1]);
          mma_asplit(acc[2 * np + 1], ma, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        rs_a += __shfl_xor_sync(0xffffffffu, rs_a, off);
        rs_b += __shfl_xor_sync(0xffffffffu, rs_b, off);
        da_a += __shfl_xor_sync(0xffffffffu, da_a, off);
        da_b += __shfl_xor_sync(0xffffffffu, da_b, off);
      }
      if (t == 0) {
        if (va) dar[ia] = rs_a + ea * da_a;
        if (vb) dar[ib] = rs_b + eb * da_b;
      }
    }
    if (dcp != nullptr) {  // the phase's dC, summed over the cluster's heads
      for (int hf = 0; hf < 2 && 16 * (8 * m + 4 * hf) < l.R; ++hf) {
        cluster_sync();  // every block has read the previous round's stage
        if (st < nst && (st - 8 * m) / 4 == hf) stage_rows(stage, l.ldst, 16 * (st - 8 * m - 4 * hf), acc, NT);
        cluster_sync();
        cluster_sum(dcp, stage, l.ldst, 16 * (8 * m + 4 * hf), Q, N, ck);
      }
    }
  }

  // ---- pass 2 (rows j): g in place of s (with <g, s> on the way), C, dy ----
  __syncthreads();  // pass 1 is done with B, x and s
  float gsum = 0.f;  // <g, s>, this thread's part
  {
    const float* src = p.gst + (bh * p.nc + c) * NPn;
    for (int e = 4 * threadIdx.x; e < l.NP * P; e += 4 * kThreads) {
      const int n = e / P, col = e % P;
      float4* sp = reinterpret_cast<float4*>(st_m + n * l.lds + col);
      const float4 gv = n < N ? *reinterpret_cast<const float4*>(src + n * P + col)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 sv = *sp;
      gsum += gv.x * sv.x + gv.y * sv.y + gv.z * sv.z + gv.w * sv.w;
      *sp = gv;
    }
  }
  load_rows_bf16(ct, l.ldb, cg, p.c_ss, l.R, Q, N, l.NP, p.vec_bc);
  load_rows_f32(dyt, l.ldy, dyg, p.dy_ss, l.R, Q, P, p.vec_dy);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int m = 0; 8 * m < nst; ++m) {
    const int st = 8 * m + (warp < 4 ? warp : 11 - warp);
    float acc[kMaxNt][4];  // dB of the strip
#pragma unroll
    for (int nt = 0; nt < kMaxNt; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    if (st < nst) {
      const int j0 = 16 * st, ja = j0 + g, jb = ja + 8;
      const bool va = ja < Q, vb = jb < Q;
      uint32_t bf[kMaxKs][4];  // B's A fragments of the strip
      load_a_bf16<kMaxKs>(bf, bg, p.b_ss, ja, Q, N, KS, p.vec_bc);
      uint32_t xf[KP][4];  // x's
      load_a_bf16<KP>(xf, xg, p.x_ss, ja, Q, P, KP, p.vec_x);
      const float dta = dt_s[ja], dtb = dt_s[jb];
      const float aja = a_s[ja], ajb = a_s[jb];
      const float eda = va ? expf(a_last - aja) : 0.f, edb = vb ? expf(a_last - ajb) : 0.f;
      // the state's terms: gx_j = dt_j x_j g^T, dB_j = ed_j gx_j,
      // u_j = ed_j B_j . gx_j, dxdt_j = ed_j B_j g (ed_j = exp(a_Q - a_j))
#pragma unroll
      for (int nt = 0; nt < kMaxNt; ++nt) {
        if (nt >= NT) continue;
#pragma unroll
        for (int kp = 0; kp < KP; ++kp) {
          const float* sp = st_m + (8 * nt + g) * l.lds + 16 * kp + 2 * t;
          mma_bsplit(acc[nt], xf[kp], split_pair(sp[0], sp[1]), split_pair(sp[8], sp[9]));
        }
      }
      float u_a = 0.f, u_b = 0.f;
#pragma unroll
      for (int nt = 0; nt < kMaxNt; ++nt) {
        if (nt >= NT) continue;
        acc[nt][0] *= dta;
        acc[nt][1] *= dta;
        acc[nt][2] *= dtb;
        acc[nt][3] *= dtb;
        const float2 ba = unpack_bf2(bf[nt / 2][(nt % 2) * 2]);
        const float2 bb = unpack_bf2(bf[nt / 2][(nt % 2) * 2 + 1]);
        u_a += ba.x * acc[nt][0] + ba.y * acc[nt][1];
        u_b += bb.x * acc[nt][2] + bb.y * acc[nt][3];
        acc[nt][0] *= eda;
        acc[nt][1] *= eda;
        acc[nt][2] *= edb;
        acc[nt][3] *= edb;
      }
      float xacc[PT][4];  // dxdt of the strip
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        xacc[pt][0] = xacc[pt][1] = xacc[pt][2] = xacc[pt][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kMaxKs; ++ks) {
          if (ks >= KS) continue;
          const float* q = st_m + (16 * ks + 2 * t) * l.lds + 8 * pt + g;
          mma_bsplit(xacc[pt], bf[ks], split_pair(q[0], q[l.lds]),
                     split_pair(q[8 * l.lds], q[9 * l.lds]));
        }
        xacc[pt][0] *= eda;
        xacc[pt][1] *= eda;
        xacc[pt][2] *= edb;
        xacc[pt][3] *= edb;
      }
      // the blocks of 16 rows i at or below the diagonal
      float cs_a = 0.f, cs_b = 0.f;
      for (int ib = st; ib < nst; ++ib) {
        const int i0 = 16 * ib;
        float sT[2][4] = {}, dT[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < kMaxKs; ++ks) {  // S^T = B C^T
          if (ks >= KS) continue;
          uint32_t cb[4];
          ldmatrix_x4(cb, ct + (i0 + (lane % 8) + (lane / 16) * 8) * l.ldb + 16 * ks +
                              ((lane / 8) % 2) * 8);
          mma_16816(sT[0], bf[ks], cb[0], cb[1]);
          mma_16816(sT[1], bf[ks], cb[2], cb[3]);
        }
#pragma unroll
        for (int kp = 0; kp < KP; ++kp) {  // x dy^T
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            const float* q = dyt + (i0 + 8 * nn + g) * l.ldy + 16 * kp + 2 * t;
            mma_bsplit(dT[nn], xf[kp], split_pair(q[0], q[1]), split_pair(q[8], q[9]));
          }
        }
        // M^T = L^T o dt_j o (x dy^T), T^T = L^T o S^T, W^T = S^T o M^T
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = e < 2 ? ja : jb;
            const int i = i0 + 8 * nn + 2 * t + (e & 1);
            const bool ok = causal(i, j, Q);
            const float diff = ok ? a_s[i] - (e < 2 ? aja : ajb) : 0.f;
            const float L = ok ? expf(diff) : 0.f;
            const float mv = L * (e < 2 ? dta : dtb) * dT[nn][e];
            (e < 2 ? cs_a : cs_b) += sT[nn][e] * mv;
            dT[nn][e] = mv;
            sT[nn][e] *= L;
          }
        }
        const SplitA ma = split_acc(dT), ta = split_acc(sT);
#pragma unroll
        for (int np = 0; np < kMaxKs; ++np) {  // dB_j += M^T C_i
          if (np >= KS) continue;
          uint32_t cb[4];
          ldmatrix_x4_trans(cb, ct + (i0 + (lane % 16)) * l.ldb + 16 * np + (lane / 16) * 8);
          mma_asplit(acc[2 * np], ma, cb[0], cb[1]);
          mma_asplit(acc[2 * np + 1], ma, cb[2], cb[3]);
        }
#pragma unroll
        for (int pt = 0; pt < PT; ++pt) {  // dxdt_j += T^T dy_i
          const float* q = dyt + (i0 + 2 * t) * l.ldy + 8 * pt + g;
          mma_split6(xacc[pt], ta, split_pair(q[0], q[l.ldy]),
                     split_pair(q[8 * l.ldy], q[9 * l.ldy]));
        }
      }
      // dx = dt dxdt in x's type; ddt = x . dxdt
      float dd_a = 0.f, dd_b = 0.f;
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        const float2 xa = unpack_bf2(xf[pt / 2][(pt % 2) * 2]);
        const float2 xb = unpack_bf2(xf[pt / 2][(pt % 2) * 2 + 1]);
        dd_a += xa.x * xacc[pt][0] + xa.y * xacc[pt][1];
        dd_b += xb.x * xacc[pt][2] + xb.y * xacc[pt][3];
        if (p.dx != nullptr) {
          __nv_bfloat16* dxg = static_cast<__nv_bfloat16*>(p.dx) + 8 * pt + 2 * t;
          if (va)
            *reinterpret_cast<__nv_bfloat162*>(dxg + ((b * S + s0 + ja) * p.H + h) * P) =
                __floats2bfloat162_rn(dta * xacc[pt][0], dta * xacc[pt][1]);
          if (vb)
            *reinterpret_cast<__nv_bfloat162*>(dxg + ((b * S + s0 + jb) * p.H + h) * P) =
                __floats2bfloat162_rn(dtb * xacc[pt][2], dtb * xacc[pt][3]);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        cs_a += __shfl_xor_sync(0xffffffffu, cs_a, off);
        cs_b += __shfl_xor_sync(0xffffffffu, cs_b, off);
        u_a += __shfl_xor_sync(0xffffffffu, u_a, off);
        u_b += __shfl_xor_sync(0xffffffffu, u_b, off);
        dd_a += __shfl_xor_sync(0xffffffffu, dd_a, off);
        dd_b += __shfl_xor_sync(0xffffffffu, dd_b, off);
      }
      if (t == 0) {
        if (va) {
          dac[ja] = cs_a;
          u_s[ja] = eda * u_a;
          if (p.ddt != nullptr) p.ddt[(b * S + s0 + ja) * p.H + h] = dd_a;
        }
        if (vb) {
          dac[jb] = cs_b;
          u_s[jb] = edb * u_b;
          if (p.ddt != nullptr) p.ddt[(b * S + s0 + jb) * p.H + h] = dd_b;
        }
      }
    }
    if (dbp != nullptr) {  // the phase's dB, summed over the cluster's heads
      for (int hf = 0; hf < 2 && 16 * (8 * m + 4 * hf) < l.R; ++hf) {
        cluster_sync();
        if (st < nst && (st - 8 * m) / 4 == hf) stage_rows(stage, l.ldst, 16 * (st - 8 * m - 4 * hf), acc, NT);
        cluster_sync();
        cluster_sum(dbp, stage, l.ldst, 16 * (8 * m + 4 * hf), Q, N, ck);
      }
    }
  }

  // ---- da: the two sums' difference, u, and the terms at a_Q ----
  if (p.da != nullptr) {
    gsum = block_sum(gsum, red);  // its syncs also order the dar, dac and u writes before the reads
    float usum = 0.f;
    for (int i = threadIdx.x; i < Q; i += kThreads) usum += u_s[i];
    usum = block_sum(usum, red);
    for (int i = threadIdx.x; i < Q; i += kThreads) {
      float v = dar[i] - dac[i] - u_s[i];
      if (i == Q - 1) v += expf(a_last) * gsum + usum;
      p.da[(b * S + s0 + i) * p.H + h] = v;
    }
  }
  cluster_sync();  // no block leaves while the cluster still reads its stage
}

// (c) dB and dC of each group: its H / (G ck) partials summed in ascending
// order in f32, rounded once to bf16.
__global__ void __launch_bounds__(kThreads) ssd_bwd_group_sum(Params p) {
  const long long S = (long long)p.nc * p.Q;
  const long long total = (long long)p.B * S * p.G * p.N;
  const float* src = blockIdx.y == 0 ? p.dbh : p.dch;
  __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(blockIdx.y == 0 ? p.db : p.dc);
  if (src == nullptr || dst == nullptr) return;
  const int parts = p.H / p.ck, per_group = parts / p.G;
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kThreads) {
    const int n = e % p.N;
    const long long rest = e / p.N;
    const int grp = rest % p.G;
    const long long bs = rest / p.G;
    const long long s = bs % S, b = bs / S;
    float v = 0.f;
    for (int q = grp * per_group; q < (grp + 1) * per_group; ++q)
      v += src[((b * parts + q) * S + s) * p.N + n];
    dst[e] = __float2bfloat16(v);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Dynamic shared memory of one block of the route's launch `stage` (1: the
// state scan, or on the bf16 route the chunks' own terms; 2: the chunks) at
// these shapes, in bytes; -1 for shapes the route refuses.  f32: N up to
// 128, P 16, 32, 64 or 128.  bf16: N a multiple of 8 up to 128, P 16, 32 or
// 64, a chunk of at most 256 rows.  Both: at most kMaxSmem.
long long route_smem(int dtype, int stage, int N, int P, int Q) {
  if (N <= 0 || Q <= 0 || (stage != 1 && stage != 2)) return -1;
  long long bytes = -1;
  if (dtype == 0) {
    if (N > 32 * kMaxNC || (P != 16 && P != 32 && P != 64 && P != 128)) return -1;
    bytes = 4 * (stage == 1 ? state_smem_floats(N, P) : chunk_layout(N, P, Q).total);
  } else if (dtype == 1) {
    if (N % 8 != 0 || N > 16 * kMaxKs || Q > kMmaMaxQ || (P != 16 && P != 32 && P != 64))
      return -1;
    bytes = stage == 1 ? delta_layout(N, P, Q).total : mma_layout(N, P, Q).total;
  }
  return bytes > kMaxSmem ? -1 : bytes;
}

long long smem_bytes(int stage, int N, int P, int Q) { return route_smem(0, stage, N, P, Q); }

template <auto kernel>
cudaError_t launch(dim3 grid, int smem, cudaStream_t stream, const Params& p) {
  // a runtime call first: autograd's device thread may have made none yet
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t run(const Params& p, int stages, cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  if (stages & 1) {
    const long long smem = smem_bytes(1, p.N, P, p.Q);
    if (smem < 0) return cudaErrorInvalidValue;
    err = launch<ssd_bwd_state<T, P>>(dim3(p.H, p.B), static_cast<int>(smem), st, p);
    if (err != cudaSuccess) return err;
  }
  if (stages & 2) {
    const long long smem = smem_bytes(2, p.N, P, p.Q);
    if (smem < 0) return cudaErrorInvalidValue;
    err = launch<ssd_bwd_chunk<T, P>>(dim3(p.nc, p.H, p.B), static_cast<int>(smem), st, p);
    if (err != cudaSuccess) return err;
  }
  if (stages & 4) {
    const long long total = (long long)p.B * p.nc * p.Q * p.G * p.N;
    const long long blocks = (total + kThreads - 1) / kThreads;
    err = launch<ssd_bwd_head_sum<T>>(dim3(static_cast<unsigned>(blocks < 65535 ? blocks : 65535),
                                           2), 0, st, p);
  }
  return err;
}

// The bf16 route: bit 1 the chunks' own terms and the combine (8 and 16 make
// either alone), 2 the chunks (clusters of ck heads), 4 the group sum.
template <int P>
cudaError_t run_mma(const Params& p, int stages, cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  if (stages & (1 | 8)) {
    const long long smem = route_smem(1, 1, p.N, P, p.Q);
    if (smem < 0) return cudaErrorInvalidValue;
    err = launch<ssd_bwd_delta_mma<P>>(dim3(p.H, p.nc, p.B), static_cast<int>(smem), st, p);
    if (err != cudaSuccess) return err;
  }
  if (stages & (1 | 16)) {
    const long long total = (long long)p.B * p.H * p.N * P;
    const long long blocks = (total + kThreads - 1) / kThreads;
    err = launch<ssd_bwd_combine>(dim3(static_cast<unsigned>(blocks < 65535 ? blocks : 65535)),
                                  0, st, p);
    if (err != cudaSuccess) return err;
  }
  if (stages & 2) {
    const long long smem = route_smem(1, 2, p.N, P, p.Q);
    if (smem < 0) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(ssd_bwd_chunk_mma<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.ck;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.H, p.nc, p.B);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, ssd_bwd_chunk_mma<P>, p);
    if (err != cudaSuccess) return err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (stages & 4) {
    const long long total = (long long)p.B * p.nc * p.Q * p.G * p.N;
    const long long blocks = (total + kThreads - 1) / kThreads;
    err = launch<ssd_bwd_group_sum>(dim3(static_cast<unsigned>(blocks < 65535 ? blocks : 65535), 2),
                                    0, st, p);
  }
  return err;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

// The arguments come packed in one array of 43 int64, in this order:
//  0-16   pointers x, dt, a, B, C, dy, states, dfin, gst, dinit, dx, ddt, da,
//         dbh, dch, db, dc (see Params; null where the note says it may be);
//  17-24  dtype (0 = float32, 1 = bfloat16: x, B and C alike; dy is f32),
//         batch, H, G, N (at most 128), P, Q, nc;
//  25-42  element strides (b, h, s) of x, dt, a, (b, g, s) of B and C,
//         (b, h, s) of dy.
// dbh and dch hold ssd_scan_bwd_head_planes(dtype, H, G) planes of
// (S, N) f32 a batch: per head on the f32 route, per cluster of heads on
// the bf16 route.  `stages`: a bit mask of the launches to make, in order:
// 1 the reverse state scan (writes gst and dinit; on the bf16 route the
// chunks' own terms and the combine, which 8 and 16 make alone), 2 the
// chunks' gradients (reads gst; writes dx, ddt, da, dbh, dch), 4 the head
// sum (dbh, dch -> db, dc).  Returns the first CUDA error (0 on success);
// nothing is synchronised.
int ssd_scan_bwd(const long long* v, int stages, void* stream) {
  auto ptr = [&](int i) { return reinterpret_cast<void*>(v[i]); };
  auto fptr = [&](int i) { return reinterpret_cast<float*>(v[i]); };
  Params p{ptr(0),  fptr(1),  fptr(2),  ptr(3),   ptr(4),   fptr(5),  fptr(6),  fptr(7),
           fptr(8), fptr(9),  ptr(10),  fptr(11), fptr(12), fptr(13), fptr(14), ptr(15),
           ptr(16),
           static_cast<int>(v[17]), static_cast<int>(v[18]), static_cast<int>(v[19]),
           static_cast<int>(v[20]), static_cast<int>(v[21]), static_cast<int>(v[22]),
           static_cast<int>(v[23]), static_cast<int>(v[24]),
           v[25], v[26], v[27], v[28], v[29], v[30], v[31], v[32], v[33],
           v[34], v[35], v[36], v[37], v[38], v[39], v[40], v[41], v[42]};
  if (p.G <= 0 || p.H % p.G != 0 || p.N <= 0 || p.Q <= 0 || p.nc <= 0 || p.B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.dtype == 0) {
    switch (p.P) {
      case 16: return static_cast<int>(run<float, 16>(p, stages, st));
      case 32: return static_cast<int>(run<float, 32>(p, stages, st));
      case 64: return static_cast<int>(run<float, 64>(p, stages, st));
      case 128: return static_cast<int>(run<float, 128>(p, stages, st));
    }
  } else if (p.dtype == 1) {
    p.ck = head_cluster(p.H, p.G);
    p.vec_bc = aligned16(p.bm) && aligned16(p.cm) && p.b_sb % 8 == 0 && p.b_sg % 8 == 0 &&
               p.b_ss % 8 == 0 && p.c_sb % 8 == 0 && p.c_sg % 8 == 0 && p.c_ss % 8 == 0;
    p.vec_x = aligned16(p.x) && p.x_sb % 8 == 0 && p.x_sh % 8 == 0 && p.x_ss % 8 == 0;
    p.vec_dy = aligned16(p.dy) && p.dy_sb % 4 == 0 && p.dy_sh % 4 == 0 && p.dy_ss % 4 == 0;
    switch (p.P) {
      case 16: return static_cast<int>(run_mma<16>(p, stages, st));
      case 32: return static_cast<int>(run_mma<32>(p, stages, st));
      case 64: return static_cast<int>(run_mma<64>(p, stages, st));
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory, in bytes, of one block of the launch `stage` (1:
// the state scan, on the bf16 route the chunks' own terms of it; 2: the
// chunks) of the route of `dtype` (0 f32, 1 bf16) at these shapes: what a
// launch gives one block, -1 where the launch refuses the shapes (f32: N
// above 128, P not 16, 32, 64 or 128; bf16: route_smem's note; either:
// more than 227 KB).
long long ssd_scan_bwd_route_smem_bytes(int dtype, int stage, int N, int P, int Q) {
  return route_smem(dtype, stage, N, P, Q);
}

// Planes of (S, N) f32 a batch that dbh and dch must hold: H on the f32 route
// (per head), H / ck on the bf16 route (per cluster of ck heads); -1 for
// heads that are not a multiple of the groups.
int ssd_scan_bwd_head_planes(int dtype, int H, int G) {
  if (G <= 0 || H % G != 0) return -1;
  return dtype == 1 ? H / head_cluster(H, G) : H;
}

// Clusters of the bf16 route's chunks launch that the card holds at once at
// these shapes (cudaOccupancyMaxActiveClusters); -1 for refused shapes.
int ssd_scan_bwd_active_clusters(int H, int G, int N, int P, int Q) {
  const long long smem = route_smem(1, 2, N, P, Q);
  if (smem < 0 || G <= 0 || H % G != 0) return -1;
  void (*kernel)(Params) = P == 16 ? ssd_bwd_chunk_mma<16>
                           : P == 32 ? ssd_bwd_chunk_mma<32>
                                     : ssd_bwd_chunk_mma<64>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = head_cluster(H, G);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, 1, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return -1;
  return n;
}

const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
