// Mamba2 SSD chunked scan for Hopper (sm_90a), with a plain C interface that
// kernels/ssd_scan.py loads through ctypes.
//
// Replaces src/repro/kernels/ssd_scan.py::_ssd_kernel, the Pallas TPU kernel
// behind repro.kernels.ssd_scan.ssd_scan_pallas.  Same function: for each
// (batch, head) the chunks of length Q are walked in order, carrying an
// (N, P) f32 state s.  Per chunk, with a the within-chunk cumsum of dt*A
// (non-increasing, since dt > 0 and A < 0):
//
//   y_i = sum_{j <= i} (C_i . B_j) exp(a_i - a_j) dt_j x_j + exp(a_i) C_i . s
//   s  <- exp(a_Q) s + sum_j exp(a_Q - a_j) B_j (x) dt_j x_j
//
// Two outputs beyond the Pallas kernel's: the state after the last chunk,
// (B, H, N, P) f32, which the model's prefill hands to decode, and, when its
// pointer is given, the state entering each chunk, (B, H, nc, N, P) f32,
// which training saves for the backward (csrc/ssd_scan_bwd.cu) so that the
// backward never rescans the forward: the block holds that state in shared
// memory already, so it costs one store of N x P floats per chunk.  With a
// null pointer the launch is the serving one, store for store.  An initial
// state may be given (null: zeros).  y is written in f32 or in the inputs'
// type; the wrapper adds D*x and casts on the model path, as
// repro.models.ssm.ssd_scan does after its scan.
//
// The TPU's sequential chunk axis becomes a loop inside one block per
// (b, h): blocks run in no order on Hopper, so nothing may carry between
// them.  The state lives in shared memory as f32 for the whole sequence and
// never goes to device memory between chunks; every row of a chunk reads
// the state from before the chunk's update.
//
// Layouts are read through strides, so the model's (B, S, H, P) x and
// (B, S, G, N) B and C need no copy: head h reads group h / (H / G) in place
// of the reference's expanded (B, S, H, N) copy.  The last dimension of x,
// B, C and y is dense.  dt and a are f32.
//
// Exponents: exp(a_i - a_j) is taken only where j <= i < Q, and the
// exponent is masked before the exp; it is never factored into
// exp(a_i) * exp(-a_j), which overflows (at the full models' random init the
// pre-softplus dt has std 6 to 17, so a falls by hundreds to thousands within
// a chunk).  Rows past Q (a chunk that is not a multiple of 64, e.g. a
// 100-token prompt) are zero in every tile and never stored.
//
// What bounds it on an H100: at Mamba2-2.7B's prefill shape (B 8, H 80,
// S 2048, Q 256, P 64, N 128, G 1) the bytes are about 0.54 GB (x 168 MB,
// B and C 8 MB, dt and a 10 MB, y in f32 336 MB, the state 21 MB), 0.16 ms
// at 3.35 TB/s; the work is about 21 MFLOP per (b, h, chunk), 108 GFLOP in
// all, 0.11 ms at the bf16 tensor-core peak and 1.6 ms at the f32 peak of
// the CUDA cores.  Two routes, chosen by the inputs' type alone:
//
// * bf16 (x, B and C bfloat16: the serving path), ssd_scan_mma: the four
//   products on tensor cores, mma.sync.m16n8k16 with f32 accumulators.  C,
//   B and x are exact bf16 operands; the other side of each product is f32
//   and goes in as three bf16 parts, v = hi + mid + lo (each the rounding of
//   what the parts before it leave), one MMA per part, so every product
//   keeps f32-level accuracy (the parts hold 24 bits of v, and a product of
//   two bf16 values is exact in f32).
//     - C . B^T: C's A-fragments of a warp's 16 rows stay in registers for
//       the row tile; B comes from shared memory through ldmatrix.  Column
//       blocks of 16 strictly right of a strip's diagonal are skipped; the
//       diagonal block is masked in registers.
//     - W . x: W = (C B^T) o exp(a_i - a_j) o dt_j is formed in the score
//       fragments and split into the A-fragments of the next product in
//       registers (the FlashAttention 2 pattern): W never goes to shared
//       memory; x comes through ldmatrix.trans.
//     - C . s: the state's f32 master copy in shared memory is split into
//       B-fragments as it is read.
//     - The state update: (exp(a_Q - a_j) dt_j B_j)^T, from the B tile
//       through ldmatrix.trans, scaled and split in registers, times x; the
//       accumulators start from exp(a_Q) s and go back to the master copy.
//   Tiles of 64 chunk rows of B and x come in bf16 through 16-byte cp.async,
//   double-buffered, so the next tile arrives during the current one's
//   MMAs; x, B and C are each read from device memory once per chunk (the
//   row tiles re-read B and x, mostly from L2).  Rows of shared memory are
//   padded by 16 bytes, so the eight rows of each ldmatrix fall on distinct
//   banks.  At N 128 a block takes 89 KB of shared memory, so two blocks
//   fit an SM.  N must be a multiple of 8, at most 128.
// * f32 (x, B and C float32: the f32 checks and reference runs),
//   ssd_scan_f32: multiplies in f32 on the CUDA cores, as the TPU kernel
//   multiplies in f32; each product of two tiles is register-tiled (a
//   thread owns 4 rows x P/16 columns, 4 x 4 of the 64 x 64 score tile),
//   the operands in padded shared memory (row stride N + 1), the state
//   double-buffered (the next state is built beside the current one).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kTile = 64;      // chunk rows (and columns) per tile
constexpr int kMaxSmem = 232448;

struct Params {
  const void* x;       // (b, h, s, p), p dense
  const float* dt;     // (b, h, s)
  const float* a;      // (b, h, s): the within-chunk cumsum of dt * A
  const void* bm;      // (b, g, s, n), n dense
  const void* cm;      // (b, g, s, n), n dense
  const float* init;   // (B, H, N, P) contiguous, or null (zeros)
  void* y;             // (b, h, s, p), p dense; f32 or the inputs' type
  float* fin;          // (B, H, N, P) contiguous, or null
  float* states;       // (B, H, nc, N, P) contiguous, or null: the state entering each chunk
  int H, G, N, Q, nc, y_f32, vec;
  long long x_sb, x_sh, x_ss;
  long long dt_sb, dt_sh, dt_ss;
  long long a_sb, a_sh, a_ss;
  long long b_sb, b_sg, b_ss;
  long long c_sb, c_sg, c_ss;
  long long y_sb, y_sh, y_ss;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

// Shared floats: two states, the C and B tiles (row stride N + 1), the x*dt
// tile, the score tile (row stride 65), a and dt of the chunk.
__host__ __device__ inline long long smem_floats(int N, int P, int Q) {
  const long long nt = (Q + kTile - 1) / kTile;
  return 2LL * N * P + 2LL * kTile * (N + 1) + (long long)kTile * P +
         kTile * (kTile + 1) + 2 * nt * kTile;
}

// Rows [row0, row0 + 64) of the chunk's (Q, N) slab of B or C into dst (row
// stride N + 1), zero past Q.  With `decay_a`, row i is scaled by
// exp(a_last - a_i) <= 1 (the decay from position i to the chunk's end).
template <typename T>
__device__ __forceinline__ void load_bc(float* dst, const T* src, long long ss,
                                        long long s0, int row0, int Q, int N,
                                        const float* decay_a, float a_last) {
  for (int e = threadIdx.x; e < kTile * N; e += kThreads) {
    const int r = e / N, n = e - (e / N) * N;
    const int i = row0 + r;
    float v = 0.f;
    if (i < Q) {
      v = to_f32(src[(s0 + i) * ss + n]);
      if (decay_a != nullptr) v *= expf(a_last - decay_a[i]);
    }
    dst[r * (N + 1) + n] = v;
  }
}

// Rows [row0, row0 + 64) of x * dt into dst (row stride P), zero past Q.
template <typename T, int P>
__device__ __forceinline__ void load_xdt(float* dst, const T* src, long long ss,
                                         long long s0, int row0, int Q,
                                         const float* dt_s) {
  for (int e = threadIdx.x; e < kTile * P; e += kThreads) {
    const int r = e / P, col = e % P;
    const int i = row0 + r;
    dst[e] = i < Q ? to_f32(src[(s0 + i) * ss + col]) * dt_s[i] : 0.f;
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads) ssd_scan_f32(Params p) {
  constexpr int PC = P / 16;  // output columns per thread
  const int N = p.N, Q = p.Q;
  const int LDN = N + 1;
  const int nt = (Q + kTile - 1) / kTile;
  extern __shared__ __align__(16) float smem[];
  float* s_cur = smem;
  float* s_next = s_cur + N * P;
  float* c_s = s_next + N * P;
  float* b_s = c_s + kTile * LDN;
  float* x_s = b_s + kTile * LDN;
  float* w_s = x_s + kTile * P;
  float* a_s = w_s + kTile * (kTile + 1);
  float* dt_s = a_s + nt * kTile;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const float* ag = p.a + b * p.a_sb + h * p.a_sh;
  const T* bg = static_cast<const T*>(p.bm) + b * p.b_sb + g * p.b_sg;
  const T* cg = static_cast<const T*>(p.cm) + b * p.c_sb + g * p.c_sg;
  const long long st0 = ((long long)b * p.H + h) * N * P;

  for (int e = threadIdx.x; e < N * P; e += kThreads)
    s_cur[e] = p.init != nullptr ? p.init[st0 + e] : 0.f;

  for (int c = 0; c < p.nc; ++c) {
    const long long s0 = (long long)c * Q;
    __syncthreads();  // the previous chunk is done with every buffer
    for (int i = threadIdx.x; i < nt * kTile; i += kThreads) {
      a_s[i] = i < Q ? ag[(s0 + i) * p.a_ss] : 0.f;
      dt_s[i] = i < Q ? dtg[(s0 + i) * p.dt_ss] : 0.f;
    }
    __syncthreads();
    const float a_last = a_s[Q - 1];
    if (p.states != nullptr) {
      float* out = p.states + (((long long)b * p.H + h) * p.nc + c) * N * P;
      for (int e = threadIdx.x; e < N * P; e += kThreads) out[e] = s_cur[e];
    }

    // 1. The next state beside the current one:
    //    s_next = exp(a_last) s_cur + sum_j (exp(a_last - a_j) B_j) (x) (dt_j x_j).
    //    This thread owns the entries (n0 + ty + 16k, tx + 16m).
    const float chunk_decay = expf(a_last);
    for (int e = threadIdx.x; e < N * P; e += kThreads)
      s_next[e] = chunk_decay * s_cur[e];
    for (int ct = 0; ct < nt; ++ct) {
      __syncthreads();  // earlier readers of b_s / x_s are done
      load_bc(b_s, bg, p.b_ss, s0, ct * kTile, Q, N, a_s, a_last);
      load_xdt<T, P>(x_s, xg, p.x_ss, s0, ct * kTile, Q, dt_s);
      __syncthreads();
      for (int n0 = 0; n0 < N; n0 += kTile) {
        float acc[4][PC] = {};
        for (int j = 0; j < kTile; ++j) {
          float bv[4], xv[PC];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int n = n0 + ty + 16 * k;
            bv[k] = n < N ? b_s[j * LDN + n] : 0.f;
          }
#pragma unroll
          for (int m = 0; m < PC; ++m) xv[m] = x_s[j * P + tx + 16 * m];
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int m = 0; m < PC; ++m) acc[k][m] += bv[k] * xv[m];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int n = n0 + ty + 16 * k;
          if (n >= N) continue;
#pragma unroll
          for (int m = 0; m < PC; ++m) s_next[n * P + tx + 16 * m] += acc[k][m];
        }
      }
    }

    // 2. The chunk's rows in tiles of 64; this thread owns rows
    //    i0 + ty + 16k and columns tx + 16m of each.
    for (int rt = 0; rt < nt; ++rt) {
      const int i0 = rt * kTile;
      __syncthreads();  // earlier readers of c_s are done
      load_bc<T>(c_s, cg, p.c_ss, s0, i0, Q, N, nullptr, 0.f);
      __syncthreads();

      // inter-chunk: exp(a_i) C_i . s, the state from before this chunk
      const float* s_read = s_cur;
      float acc[4][PC] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PC];
#pragma unroll
        for (int k = 0; k < 4; ++k) cv[k] = c_s[(ty + 16 * k) * LDN + n];
#pragma unroll
        for (int m = 0; m < PC; ++m) sv[m] = s_read[n * P + tx + 16 * m];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int m = 0; m < PC; ++m) acc[k][m] += cv[k] * sv[m];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + ty + 16 * k;
        const float e = i < Q ? expf(a_s[i]) : 0.f;
#pragma unroll
        for (int m = 0; m < PC; ++m) acc[k][m] *= e;
      }

      // intra-chunk: the column tiles at or left of the diagonal
      for (int ct = 0; ct <= rt; ++ct) {
        const int j0 = ct * kTile;
        __syncthreads();  // earlier readers of b_s / x_s / w_s are done
        load_bc<T>(b_s, bg, p.b_ss, s0, j0, Q, N, nullptr, 0.f);
        load_xdt<T, P>(x_s, xg, p.x_ss, s0, j0, Q, dt_s);
        __syncthreads();
        // W = (C B^T) o L with L_ij = exp(a_i - a_j) for j <= i < Q
        float w[4][4] = {};
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) cv[k] = c_s[(ty + 16 * k) * LDN + n];
#pragma unroll
          for (int m = 0; m < 4; ++m) bv[m] = b_s[(tx + 16 * m) * LDN + n];
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int m = 0; m < 4; ++m) w[k][m] += cv[k] * bv[m];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int i = i0 + ty + 16 * k, j = j0 + tx + 16 * m;
            const bool ok = j <= i && i < Q;
            const float diff = ok ? a_s[i] - a_s[j] : 0.f;  // masked before the exp
            w_s[(ty + 16 * k) * (kTile + 1) + tx + 16 * m] = ok ? w[k][m] * expf(diff) : 0.f;
          }
        }
        __syncthreads();
        for (int j = 0; j < kTile; ++j) {
          float wv[4], xv[PC];
#pragma unroll
          for (int k = 0; k < 4; ++k) wv[k] = w_s[(ty + 16 * k) * (kTile + 1) + j];
#pragma unroll
          for (int m = 0; m < PC; ++m) xv[m] = x_s[j * P + tx + 16 * m];
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int m = 0; m < PC; ++m) acc[k][m] += wv[k] * xv[m];
        }
      }

#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + ty + 16 * k;
        if (i >= Q) continue;
        const long long row = b * p.y_sb + h * p.y_sh + (s0 + i) * p.y_ss;
#pragma unroll
        for (int m = 0; m < PC; ++m) {
          const int col = tx + 16 * m;
          if (p.y_f32)
            static_cast<float*>(p.y)[row + col] = acc[k][m];
          else
            from_f32(acc[k][m], static_cast<T*>(p.y) + row + col);
        }
      }
    }

    __syncthreads();  // every row has read s_cur
    float* t = s_cur;
    s_cur = s_next;
    s_next = t;
  }

  if (p.fin != nullptr)
    for (int e = threadIdx.x; e < N * P; e += kThreads) p.fin[st0 + e] = s_cur[e];
}

// ---------------------------------------------------------------------------
// bf16 route: mma.sync tensor cores, tiles through cp.async
// ---------------------------------------------------------------------------

constexpr int kRowTile = 128;  // chunk rows per row tile: 8 warps x 16
constexpr int kColTile = 64;   // chunk rows of B and x per tile
constexpr int kMaxKs = 8;      // k-steps of 16 over the state: N <= 128
constexpr int kPadH = 8;       // bf16 elements of padding per tile row (16 bytes)

// Shared memory of the bf16 route, in bytes from the start: the f32 state
// (NP rows of P + 4), two B tiles (64 x NP + 8, bf16), two x tiles (64 x
// P + 8), then a, dt and the state update's factors of the chunk (f32).
struct MmaLayout {
  int NP, ldb, ldx, lds, rows;
  long long s, b, x, a, dt, f, total;
};

__host__ __device__ inline MmaLayout mma_layout(int N, int P, int Q) {
  MmaLayout l;
  l.NP = (N + 15) / 16 * 16;
  l.ldb = l.NP + kPadH;
  l.ldx = P + kPadH;
  l.lds = P + 4;
  l.rows = (Q + kColTile - 1) / kColTile * kColTile;
  l.s = 0;
  l.b = l.s + 4LL * l.NP * l.lds;
  l.x = l.b + 2LL * 2 * kColTile * l.ldb;
  l.a = l.x + 2LL * 2 * kColTile * l.ldx;
  l.dt = l.a + 4LL * l.rows;
  l.f = l.dt + 4LL * l.rows;
  l.total = l.f + 4LL * l.rows;
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

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.  Not
// volatile: a product has no effect beyond its outputs, so the compiler may
// interleave independent products (the three parts of one product
// accumulate into the same registers and would stall back to back).
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
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  return {bf2_bits(h), bf2_bits(m), bf2_bits(l)};
}

// d += (hi + mid + lo) * b: the three parts of an f32 A-operand, each
// against the same exact bf16 B-fragment.
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&hi)[4],
                                          const uint32_t (&mid)[4], const uint32_t (&lo)[4],
                                          uint32_t b0, uint32_t b1) {
  mma_16816(d, hi, b0, b1);
  mma_16816(d, mid, b0, b1);
  mma_16816(d, lo, b0, b1);
}

// Two bf16 values at p (p[0] in the low half), as one 32-bit load where the
// rows are aligned (vec), else two 16-bit loads.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const unsigned int*>(p));
  const unsigned short lo = __ldg(reinterpret_cast<const unsigned short*>(p));
  const unsigned short hi = __ldg(reinterpret_cast<const unsigned short*>(p) + 1);
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// Rows [j0, j0 + 64) of the chunk's B (columns [0, NP)) and x into one
// buffer pair, zero past Q and past N: 16-byte cp.async where every row is
// aligned (vec), else element loads and stores.
template <int P>
__device__ __forceinline__ void load_tiles(__nv_bfloat16* bt, __nv_bfloat16* xt,
                                           const __nv_bfloat16* bg, const __nv_bfloat16* xg,
                                           const Params& p, const MmaLayout& l, long long s0,
                                           int j0) {
  const int bv = l.NP / 8;
  for (int v = threadIdx.x; v < kColTile * bv; v += kThreads) {
    const int r = v / bv, c8 = (v - r * bv) * 8, j = j0 + r;
    const bool ok = j < p.Q && c8 < p.N;
    __nv_bfloat16* d = bt + r * l.ldb + c8;
    const __nv_bfloat16* src = bg + (s0 + j) * p.b_ss + c8;
    if (p.vec) {
      cp_async16(d, ok ? src : bg, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = ok ? src[e] : __float2bfloat16(0.f);
    }
  }
  constexpr int xv = P / 8;
  for (int v = threadIdx.x; v < kColTile * xv; v += kThreads) {
    const int r = v / xv, c8 = (v % xv) * 8, j = j0 + r;
    const bool ok = j < p.Q;
    __nv_bfloat16* d = xt + r * l.ldx + c8;
    const __nv_bfloat16* src = xg + (s0 + j) * p.x_ss + c8;
    if (p.vec) {
      cp_async16(d, ok ? src : xg, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = ok ? src[e] : __float2bfloat16(0.f);
    }
  }
}

// What the two phases of a chunk share.
struct MmaChunk {
  MmaLayout l;
  const __nv_bfloat16* xg;
  const __nv_bfloat16* bg;
  const __nv_bfloat16* cg;
  float* s_m;                 // the f32 state, NP x lds
  __nv_bfloat16* b_t;         // two B tiles
  __nv_bfloat16* x_t;         // two x tiles
  const float* a_s;           // a, dt and exp(a_last - a_j) dt_j of the chunk
  const float* dt_s;
  const float* f_s;
  long long s0;               // the chunk's first position
  int b, h;
};

// Column tiles [0, count) of the chunk through the double buffer: tile k in
// buffer k % 2, tile k + 1's copies in flight while `body` runs on tile k.
template <int P, typename Body>
__device__ __forceinline__ void tile_steps(const Params& p, const MmaChunk& ch, int count,
                                           Body body) {
  const MmaLayout& l = ch.l;
  const int bsz = kColTile * l.ldb, xsz = kColTile * l.ldx;
  __syncthreads();  // earlier readers of both buffers are done
  load_tiles<P>(ch.b_t, ch.x_t, ch.bg, ch.xg, p, l, ch.s0, 0);
  cp_async_commit();
  for (int k = 0; k < count; ++k) {
    const int b = k & 1;
    cp_async_wait<0>();  // tile k has landed (this thread's copies)
    __syncthreads();     // ... everyone's; the other buffer is free
    if (k + 1 < count)
      load_tiles<P>(ch.b_t + (b ^ 1) * bsz, ch.x_t + (b ^ 1) * xsz, ch.bg, ch.xg, p, l, ch.s0,
                    (k + 1) * kColTile);
    cp_async_commit();
    body(k, ch.b_t + b * bsz, ch.x_t + b * xsz);
  }
}

// The chunk's rows: warp w owns rows [16 w, 16 w + 16) of each 128-row tile;
// y = exp(a_i) C_i . s + sum_{j <= i} W_ij x_j.
template <int P>
__device__ __forceinline__ void mma_rows(const Params& p, const MmaChunk& ch) {
  constexpr int NT = P / 8;  // n-tiles of the output columns
  const MmaLayout& l = ch.l;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int Q = p.Q, KS = l.NP / 16;
  const int n_rt = (Q + kRowTile - 1) / kRowTile;
  for (int rt = 0; rt < n_rt; ++rt) {
    const int i0 = rt * kRowTile + 16 * warp;  // the strip's first row
    const bool live = i0 < Q;
    const int ia = i0 + g, ib = ia + 8;
    float yacc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) yacc[nt][0] = yacc[nt][1] = yacc[nt][2] = yacc[nt][3] = 0.f;
    // C's A-fragments of the strip (rows ia, ib; columns 16 ks + 2t (+8))
    uint32_t cf[kMaxKs][4];
#pragma unroll
    for (int ks = 0; ks < kMaxKs; ++ks) {
      cf[ks][0] = cf[ks][1] = cf[ks][2] = cf[ks][3] = 0u;
      if (!live || ks >= KS) continue;
      const int k0 = 16 * ks + 2 * t;
      const __nv_bfloat16* ra = ch.cg + (ch.s0 + ia) * p.c_ss;
      const __nv_bfloat16* rb = ch.cg + (ch.s0 + ib) * p.c_ss;
      const bool va = ia < Q, vb = ib < Q, k_lo = k0 < p.N, k_hi = k0 + 8 < p.N;
      if (va && k_lo) cf[ks][0] = ld_pair(ra + k0, p.vec);
      if (vb && k_lo) cf[ks][1] = ld_pair(rb + k0, p.vec);
      if (va && k_hi) cf[ks][2] = ld_pair(ra + k0 + 8, p.vec);
      if (vb && k_hi) cf[ks][3] = ld_pair(rb + k0 + 8, p.vec);
    }
    const float ai = ia < Q ? ch.a_s[ia] : 0.f, bi = ib < Q ? ch.a_s[ib] : 0.f;
    if (live) {
      // inter-chunk: exp(a_i) C_i . s, the state from before this chunk,
      // its B-fragments split as they are read
#pragma unroll
      for (int ks = 0; ks < kMaxKs; ++ks) {
        if (ks >= KS) continue;
        const float* sp = ch.s_m + (16 * ks + 2 * t) * l.lds + g;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* q = sp + 8 * nt;
          const Split3 b0 = split_pair(q[0], q[l.lds]);
          const Split3 b1 = split_pair(q[8 * l.lds], q[9 * l.lds]);
          mma_16816(yacc[nt], cf[ks], b0.hi, b1.hi);
          mma_16816(yacc[nt], cf[ks], b0.mid, b1.mid);
          mma_16816(yacc[nt], cf[ks], b0.lo, b1.lo);
        }
      }
      const float ea = ia < Q ? expf(ai) : 0.f, eb = ib < Q ? expf(bi) : 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        yacc[nt][0] *= ea;
        yacc[nt][1] *= ea;
        yacc[nt][2] *= eb;
        yacc[nt][3] *= eb;
      }
    }
    // intra-chunk: the column tiles that reach this row tile
    const int n_ct = (min(Q, (rt + 1) * kRowTile) + kColTile - 1) / kColTile;
    tile_steps<P>(p, ch, n_ct, [&](int ct, const __nv_bfloat16* bt, const __nv_bfloat16* xt) {
      if (!live) return;
#pragma unroll
      for (int sb = 0; sb < kColTile / 16; ++sb) {
        const int j0 = ct * kColTile + 16 * sb;
        if (j0 > i0 || j0 >= Q) continue;  // strictly right of the diagonal, or past Q
        // S = C B^T over 16 rows x 16 columns (two n-tiles)
        float sc[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < kMaxKs; ++ks) {
          if (ks >= KS) continue;
          uint32_t bb[4];
          ldmatrix_x4(bb, bt + (16 * sb + (lane % 8) + (lane / 16) * 8) * l.ldb + 16 * ks +
                              ((lane / 8) % 2) * 8);
          mma_16816(sc[0], cf[ks], bb[0], bb[1]);
          mma_16816(sc[1], cf[ks], bb[2], bb[3]);
        }
        // W = S o exp(a_i - a_j) o dt_j for j <= i < Q, the exponent masked first
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib;
            const int j = j0 + 8 * nn + 2 * t + (e & 1);
            const bool in_mask = j <= i && i < Q;
            const float diff = in_mask ? (e < 2 ? ai : bi) - ch.a_s[j] : 0.f;
            sc[nn][e] = in_mask ? sc[nn][e] * __expf(diff) * ch.dt_s[j] : 0.f;
          }
        }
        // the score fragments are the A-fragments of W . x, in three parts
        const Split3 w0 = split_pair(sc[0][0], sc[0][1]);
        const Split3 w1 = split_pair(sc[0][2], sc[0][3]);
        const Split3 w2 = split_pair(sc[1][0], sc[1][1]);
        const Split3 w3 = split_pair(sc[1][2], sc[1][3]);
        const uint32_t whi[4] = {w0.hi, w1.hi, w2.hi, w3.hi};
        const uint32_t wmid[4] = {w0.mid, w1.mid, w2.mid, w3.mid};
        const uint32_t wlo[4] = {w0.lo, w1.lo, w2.lo, w3.lo};
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t xb[4];
          ldmatrix_x4_trans(xb, xt + (16 * sb + (lane % 16)) * l.ldx + 16 * np + (lane / 16) * 8);
          mma_split(yacc[2 * np], whi, wmid, wlo, xb[0], xb[1]);
          mma_split(yacc[2 * np + 1], whi, wmid, wlo, xb[2], xb[3]);
        }
      }
    });
    if (!live) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = hh ? ib : ia;
      if (i >= Q) continue;
      const long long row = ch.b * p.y_sb + ch.h * p.y_sh + (ch.s0 + i) * p.y_ss;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = 8 * nt + 2 * t;
        const float v0 = yacc[nt][2 * hh], v1 = yacc[nt][2 * hh + 1];
        if (p.y_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(p.y) + row + col) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.y) + row + col) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// The state update: s <- exp(a_last) s + (f o B)^T x with f_j = exp(a_last -
// a_j) dt_j.  Warp w owns state rows [16 (w % WM), + 16) (WM = NP / 16
// strips) and the n-tiles nt with nt % (8 / WM) == w / WM.
template <int P>
__device__ __forceinline__ void mma_state(const Params& p, const MmaChunk& ch, float a_last) {
  constexpr int NT = P / 8;
  const MmaLayout& l = ch.l;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int WM = l.NP / 16, WG = kThreads / 32 / WM;
  const bool live = warp < WM * WG;
  const int n0 = 16 * (warp % WM), grp = warp / WM;
  float sacc[NT][4];
  const float keep = expf(a_last);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float* q = ch.s_m + (n0 + g) * l.lds + 8 * nt + 2 * t;
    const bool mine = live && nt % WG == grp;
    sacc[nt][0] = mine ? keep * q[0] : 0.f;
    sacc[nt][1] = mine ? keep * q[1] : 0.f;
    sacc[nt][2] = mine ? keep * q[8 * l.lds] : 0.f;
    sacc[nt][3] = mine ? keep * q[8 * l.lds + 1] : 0.f;
  }
  const int n_ct = (p.Q + kColTile - 1) / kColTile;
  tile_steps<P>(p, ch, n_ct, [&](int ct, const __nv_bfloat16* bt, const __nv_bfloat16* xt) {
    if (!live) return;
#pragma unroll
    for (int kk = 0; kk < kColTile / 16; ++kk) {
      const int j0 = ct * kColTile + 16 * kk;
      if (j0 >= p.Q) continue;
      // A = (f o B)^T over state rows n0.., chunk rows j0..: B^T by
      // ldmatrix.trans, scaled by f_j and split in registers
      uint32_t bt4[4];
      ldmatrix_x4_trans(bt4, bt + (16 * kk + (lane % 8) + (lane / 16) * 8) * l.ldb + n0 +
                                 ((lane / 8) % 2) * 8);
      const float2 fa = *reinterpret_cast<const float2*>(ch.f_s + j0 + 2 * t);
      const float2 fb = *reinterpret_cast<const float2*>(ch.f_s + j0 + 2 * t + 8);
      const float2 u0 = unpack_bf2(bt4[0]), u1 = unpack_bf2(bt4[1]);
      const float2 u2 = unpack_bf2(bt4[2]), u3 = unpack_bf2(bt4[3]);
      const Split3 q0 = split_pair(u0.x * fa.x, u0.y * fa.y);
      const Split3 q1 = split_pair(u1.x * fa.x, u1.y * fa.y);
      const Split3 q2 = split_pair(u2.x * fb.x, u2.y * fb.y);
      const Split3 q3 = split_pair(u3.x * fb.x, u3.y * fb.y);
      const uint32_t ahi[4] = {q0.hi, q1.hi, q2.hi, q3.hi};
      const uint32_t amid[4] = {q0.mid, q1.mid, q2.mid, q3.mid};
      const uint32_t alo[4] = {q0.lo, q1.lo, q2.lo, q3.lo};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt % WG != grp) continue;
        uint32_t x0, x1;
        ldmatrix_x2_trans(x0, x1, xt + (16 * kk + (lane % 16)) * l.ldx + 8 * nt);
        mma_split(sacc[nt], ahi, amid, alo, x0, x1);
      }
    }
  });
  if (!live) return;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt % WG != grp) continue;
    float* q = ch.s_m + (n0 + g) * l.lds + 8 * nt + 2 * t;
    q[0] = sacc[nt][0];
    q[1] = sacc[nt][1];
    q[8 * l.lds] = sacc[nt][2];
    q[8 * l.lds + 1] = sacc[nt][3];
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads, P <= 64 ? 2 : 1) ssd_scan_mma(Params p) {
  const int N = p.N, Q = p.Q;
  const MmaLayout l = mma_layout(N, P, Q);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_m = reinterpret_cast<float*>(smem_raw + l.s);
  float* a_s = reinterpret_cast<float*>(smem_raw + l.a);
  float* dt_s = reinterpret_cast<float*>(smem_raw + l.dt);
  float* f_s = reinterpret_cast<float*>(smem_raw + l.f);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int group = h / (p.H / p.G);
  MmaChunk ch;
  ch.l = l;
  ch.xg = static_cast<const __nv_bfloat16*>(p.x) + b * p.x_sb + h * p.x_sh;
  ch.bg = static_cast<const __nv_bfloat16*>(p.bm) + b * p.b_sb + group * p.b_sg;
  ch.cg = static_cast<const __nv_bfloat16*>(p.cm) + b * p.c_sb + group * p.c_sg;
  ch.s_m = s_m;
  ch.b_t = reinterpret_cast<__nv_bfloat16*>(smem_raw + l.b);
  ch.x_t = reinterpret_cast<__nv_bfloat16*>(smem_raw + l.x);
  ch.a_s = a_s;
  ch.dt_s = dt_s;
  ch.f_s = f_s;
  ch.b = b;
  ch.h = h;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const float* ag = p.a + b * p.a_sb + h * p.a_sh;
  const long long st0 = ((long long)b * p.H + h) * N * P;

  for (int e = threadIdx.x; e < l.NP * P; e += kThreads) {
    const int n = e / P, col = e % P;
    s_m[n * l.lds + col] = p.init != nullptr && n < N ? p.init[st0 + e] : 0.f;
  }

  for (int c = 0; c < p.nc; ++c) {
    ch.s0 = (long long)c * Q;
    __syncthreads();  // the previous chunk is done with a, dt, f and the state
    for (int i = threadIdx.x; i < l.rows; i += kThreads) {
      a_s[i] = i < Q ? ag[(ch.s0 + i) * p.a_ss] : 0.f;
      dt_s[i] = i < Q ? dtg[(ch.s0 + i) * p.dt_ss] : 0.f;
    }
    __syncthreads();
    const float a_last = a_s[Q - 1];
    for (int i = threadIdx.x; i < l.rows; i += kThreads)
      f_s[i] = i < Q ? expf(a_last - a_s[i]) * dt_s[i] : 0.f;
    if (p.states != nullptr) {  // read before mma_state's first sync; written after it
      float* out = p.states + (((long long)b * p.H + h) * p.nc + c) * N * P;
      for (int e = threadIdx.x; e < N * P; e += kThreads) out[e] = s_m[(e / P) * l.lds + e % P];
    }
    // every row reads the state from before the chunk's update
    mma_rows<P>(p, ch);
    mma_state<P>(p, ch, a_last);
  }

  __syncthreads();
  if (p.fin != nullptr)
    for (int e = threadIdx.x; e < N * P; e += kThreads) p.fin[st0 + e] = s_m[(e / P) * l.lds + e % P];
}

// Dynamic shared memory of one block of the route's kernel (dtype 0: f32,
// 1: mma) at these shapes, in bytes; -1 for shapes the route does not take:
// P not 16, 32, 64 or 128, more than kMaxSmem, and on the mma route N not a
// multiple of 8 or above 16 * kMaxKs.
long long route_smem(int dtype, int N, int P, int Q) {
  if (N <= 0 || Q <= 0 || (P != 16 && P != 32 && P != 64 && P != 128)) return -1;
  long long smem = -1;
  if (dtype == 0)
    smem = smem_floats(N, P, Q) * 4;
  else if (dtype == 1 && N % 8 == 0 && N <= 16 * kMaxKs)
    smem = mma_layout(N, P, Q).total;
  return smem > kMaxSmem ? -1 : smem;
}

template <int P>
cudaError_t launch_mma(const Params& p, int batch, cudaStream_t stream) {
  const long long smem = route_smem(1, p.N, P, p.Q);
  if (smem < 0) return cudaErrorInvalidValue;
  auto kernel = ssd_scan_mma<P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.H, batch), kThreads, static_cast<int>(smem), stream>>>(p);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_f32(const Params& p, int batch, cudaStream_t stream) {
  const long long smem = route_smem(0, p.N, P, p.Q);
  if (smem < 0) return cudaErrorInvalidValue;
  auto kernel = ssd_scan_f32<float, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.H, batch), kThreads, static_cast<int>(smem), stream>>>(p);
  return cudaGetLastError();
}

using KernelFn = void (*)(Params);

// The route's kernel for head dim P (null for a P the kernel does not take).
KernelFn route_kernel(int dtype, int P) {
  if (dtype == 0) {
    switch (P) {
      case 16: return ssd_scan_f32<float, 16>;
      case 32: return ssd_scan_f32<float, 32>;
      case 64: return ssd_scan_f32<float, 64>;
      case 128: return ssd_scan_f32<float, 128>;
    }
  } else if (dtype == 1) {
    switch (P) {
      case 16: return ssd_scan_mma<16>;
      case 32: return ssd_scan_mma<32>;
      case 64: return ssd_scan_mma<64>;
      case 128: return ssd_scan_mma<128>;
    }
  }
  return nullptr;
}

}  // namespace

extern "C" {

// dtype of x, B and C (and of y unless y_f32): 0 = float32 (the f32 route),
// 1 = bfloat16 (the mma route; N a multiple of 8, at most 128).  P: 16, 32,
// 64 or 128.  Strides are in elements, for the (b, h, s) axes of x, dt, a
// and y and the (b, g, s) axes of B and C; position s = c * Q + i.  vec: 1
// when every row of x, B and C starts 16-byte aligned (the mma route's tiles
// then come through cp.async).  init and fin: (B, H, N, P) contiguous f32,
// or null; states: (B, H, nc, N, P) contiguous f32, the state entering each
// chunk, or null.  Returns the CUDA error code of the launch (0 on success); the
// kernel runs on `stream` and nothing is synchronised here.
int ssd_scan(const void* x, const float* dt, const float* a, const void* bm,
             const void* cm, const float* init, void* y, float* fin, float* states, int dtype,
             int y_f32, int batch, int H, int G, int N, int P, int Q, int nc,
             long long x_sb, long long x_sh, long long x_ss, long long dt_sb,
             long long dt_sh, long long dt_ss, long long a_sb, long long a_sh,
             long long a_ss, long long b_sb, long long b_sg, long long b_ss,
             long long c_sb, long long c_sg, long long c_ss, long long y_sb,
             long long y_sh, long long y_ss, int vec, void* stream) {
  if (G <= 0 || H % G != 0 || N <= 0 || Q <= 0 || nc <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x,     dt,    a,     bm,    cm,    init,  y,     fin,   states,
                 H,     G,     N,     Q,     nc,    y_f32, vec,   x_sb,
                 x_sh,  x_ss,  dt_sb, dt_sh, dt_ss, a_sb,  a_sh,  a_ss,
                 b_sb,  b_sg,  b_ss,  c_sb,  c_sg,  c_ss,  y_sb,  y_sh,  y_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (P) {
      case 16: return static_cast<int>(launch_f32<16>(p, batch, st));
      case 32: return static_cast<int>(launch_f32<32>(p, batch, st));
      case 64: return static_cast<int>(launch_f32<64>(p, batch, st));
      case 128: return static_cast<int>(launch_f32<128>(p, batch, st));
    }
  } else if (dtype == 1) {
    switch (P) {
      case 16: return static_cast<int>(launch_mma<16>(p, batch, st));
      case 32: return static_cast<int>(launch_mma<32>(p, batch, st));
      case 64: return static_cast<int>(launch_mma<64>(p, batch, st));
      case 128: return static_cast<int>(launch_mma<128>(p, batch, st));
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the route's kernel that one SM holds at once for these shapes
// (from the occupancy calculator: registers, threads and shared memory);
// -1 for shapes the kernel does not take.
int ssd_scan_blocks_per_sm(int dtype, int N, int P, int Q) {
  const long long smem = route_smem(dtype, N, P, Q);
  const KernelFn fn = route_kernel(dtype, P);
  if (fn == nullptr || smem < 0) return -1;
  const void* f = reinterpret_cast<const void*>(fn);
  if (cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, kThreads,
                                                    static_cast<size_t>(smem)) != cudaSuccess)
    return -1;
  return blocks;
}

// Dynamic shared memory, in bytes, that a launch of the route's kernel gives
// one block at these shapes; -1 for shapes the launch refuses.
long long ssd_scan_smem_bytes(int dtype, int N, int P, int Q) {
  return route_smem(dtype, N, P, Q);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
