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
// Three launches, each simple:
//
// (a) ssd_bwd_state, one block per (b, h): the reverse state scan.  The
//     chunks are walked from last to first with g (N x P f32) in shared
//     memory, as the forward carries s; g is written for every chunk
//     ((B, H, nc, N, P) f32) before the chunk's update, then d init.
// (b) ssd_bwd_chunk, one block per (b, h, c), where the parallelism is:
//     B H nc blocks.  Tiles of 32 chunk rows of C, B (row stride N + 1), dy
//     and xdt (P + 1) come into shared memory as f32; a thread owns rows
//     ty + 8k (k < 4) and columns tx + 32m of each product, its sums in
//     registers.  Pass 1 walks the row tiles i and, for each, the column
//     tiles j <= i: S and dS (4 values a thread), M into shared memory, the
//     row and column sums of W, and dC_i += M B_j.  Pass 2 walks the column
//     tiles j and the row tiles i >= j: dB_j += M^T C_i, dxdt_j += T^T dy_i.
//     The state terms read s (pass 1) and g (pass 2) from a copy in shared
//     memory (row stride P + 1): read from device memory, lanes that take
//     one column of 32 rows touch 32 lines a load.  dx is
//     written in x's type, ddt and da in f32, dB and dC per head in f32
//     ((B, H, S, N)).
// (c) ssd_bwd_head_sum: dB and dC of each group summed over its H / G heads
//     in ascending head order in f32, rounded once to the inputs' type.
//
// Every sum has a fixed order (warp shuffles by xor, per-warp partials
// added by one thread, a fixed head order), and there are no atomics, so a
// result is bit-equal on repeat.  Exponents are masked before the exp:
// exp(a_i - a_j) only where j <= i < Q, never exp(a_i) exp(-a_j), which
// overflows at the full models' random init (the pre-softplus dt has std 6
// to 17, so a falls by hundreds within a chunk); exp(a_i), exp(a_Q) and
// exp(a_Q - a_j) are at most 1.  The da sums cancel (the row and column sums
// of the same W): both are accumulated in f32, each in its own array.
//
// What bounds it on an H100: at mamba2-2.7b's training shape (B 1, H 80,
// S 4096, Q 256, P 64, N 128) launch (b) does about 26 M multiply-adds a
// block, 1280 blocks, 67 GFLOP in all: 1.0 ms at the f32 peak of the CUDA
// cores, 0.07 ms at the bf16 tensor-core peak; it moves about 0.45 GB (the
// per-head dB and dC in f32 are 0.34 GB of it), 0.13 ms at 3.35 TB/s.  This
// first version multiplies in f32 on the CUDA cores from shared memory (a
// tensor-core design is ROADMAP D11); launch (a) is serial over the chunks
// with B H blocks.

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
  float* dbh;           // (B, H, S, N) per head, or null
  float* dch;           // (B, H, S, N) per head, or null
  void* db;             // (B, S, G, N) in the inputs' type, or null
  void* dc;             // (B, S, G, N), or null
  int dtype, B, H, G, N, P, Q, nc;
  long long x_sb, x_sh, x_ss, dt_sb, dt_sh, dt_ss, a_sb, a_sh, a_ss;
  long long b_sb, b_sg, b_ss, c_sb, c_sg, c_ss, dy_sb, dy_sh, dy_ss;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

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
// launches
// ---------------------------------------------------------------------------

long long smem_bytes(int stage, int N, int P, int Q) {
  if (N <= 0 || N > 32 * kMaxNC || Q <= 0 || (P != 16 && P != 32 && P != 64 && P != 128))
    return -1;
  const long long floats = stage == 1 ? state_smem_floats(N, P) : chunk_layout(N, P, Q).total;
  const long long bytes = 4 * floats;
  return bytes > kMaxSmem ? -1 : bytes;
}

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

}  // namespace

extern "C" {

// The arguments come packed in one array of 43 int64, in this order:
//  0-16   pointers x, dt, a, B, C, dy, states, dfin, gst, dinit, dx, ddt, da,
//         dbh, dch, db, dc (see Params; null where the note says it may be);
//  17-24  dtype (0 = float32, 1 = bfloat16: x, B and C alike; dy is f32),
//         batch, H, G, N (at most 128), P (16, 32, 64 or 128), Q, nc;
//  25-42  element strides (b, h, s) of x, dt, a, (b, g, s) of B and C,
//         (b, h, s) of dy.
// `stages`: a bit mask of the launches to make, in order: 1 the reverse
// state scan (writes gst and dinit), 2 the chunks' gradients (reads gst;
// writes dx, ddt, da, dbh, dch), 4 the head sum (dbh, dch -> db, dc).
// Returns the first CUDA error (0 on success); nothing is synchronised.
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
    switch (p.P) {
      case 16: return static_cast<int>(run<__nv_bfloat16, 16>(p, stages, st));
      case 32: return static_cast<int>(run<__nv_bfloat16, 32>(p, stages, st));
      case 64: return static_cast<int>(run<__nv_bfloat16, 64>(p, stages, st));
      case 128: return static_cast<int>(run<__nv_bfloat16, 128>(p, stages, st));
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory, in bytes, of one block of launch `stage` (1: the
// state scan, 2: the chunks) at these shapes; -1 for shapes the launch
// refuses (N above 128, P not 16, 32, 64 or 128, more than 227 KB).
long long ssd_scan_bwd_smem_bytes(int stage, int N, int P, int Q) {
  return smem_bytes(stage, N, P, Q);
}

const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
