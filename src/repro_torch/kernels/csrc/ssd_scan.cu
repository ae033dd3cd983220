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
// One output beyond the Pallas kernel's: the state after the last chunk,
// (B, H, N, P) f32, which the model's prefill hands to decode.  An initial
// state may be given (null: zeros).  y is written in f32 or in the inputs'
// type; the wrapper adds D*x and casts on the model path, as
// repro.models.ssm.ssd_scan does after its scan.
//
// The TPU's sequential chunk axis becomes a loop inside one block per
// (b, h): blocks run in no order on Hopper, so nothing may carry between
// them.  The state lives in shared memory for the whole sequence and never
// goes to device memory between chunks.  It is double-buffered: each chunk
// first builds the next state beside the current one, then every row of the
// chunk reads the current one (every row must see the state from before its
// chunk's update), and the buffers swap at the chunk's end.
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
// the CUDA cores.  This kernel multiplies in f32 on the CUDA cores, as the
// TPU kernel multiplies in f32: each product of two tiles is register-tiled
// (a thread owns 4 rows x P/16 columns, 4 x 4 of the 64 x 64 score tile),
// the operands in padded shared memory (row stride N + 1, so the 16 threads
// that read 16 different rows at one n hit 16 banks).  Simple first: no
// tensor cores, no cp.async; the tiles of C . B^T strictly below the
// diagonal are full products, and the diagonal tile is masked.

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
  int H, G, N, Q, nc, y_f32;
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
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Params p) {
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

template <typename T, int P>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const long long smem = smem_floats(p.N, P, p.Q) * 4;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = ssd_scan_kernel<T, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.H, batch), kThreads, static_cast<int>(smem), stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(const Params& p, int P, int batch, cudaStream_t stream) {
  switch (P) {
    case 16: return launch<T, 16>(p, batch, stream);
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype of x, B and C (and of y unless y_f32): 0 = float32, 1 = bfloat16.
// P: 16, 32, 64 or 128.  Strides are in elements, for the (b, h, s) axes of
// x, dt, a and y and the (b, g, s) axes of B and C; position s = c * Q + i.
// init and fin: (B, H, N, P) contiguous f32, or null.  Returns the CUDA
// error code of the launch (0 on success); the kernel runs on `stream` and
// nothing is synchronised here.
int ssd_scan(const void* x, const float* dt, const float* a, const void* bm,
             const void* cm, const float* init, void* y, float* fin, int dtype,
             int y_f32, int batch, int H, int G, int N, int P, int Q, int nc,
             long long x_sb, long long x_sh, long long x_ss, long long dt_sb,
             long long dt_sh, long long dt_ss, long long a_sb, long long a_sh,
             long long a_ss, long long b_sb, long long b_sg, long long b_ss,
             long long c_sb, long long c_sg, long long c_ss, long long y_sb,
             long long y_sh, long long y_ss, void* stream) {
  if (G <= 0 || H % G != 0 || N <= 0 || Q <= 0 || nc <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x,     dt,    a,     bm,    cm,    init,  y,     fin,
                 H,     G,     N,     Q,     nc,    y_f32, x_sb,  x_sh,
                 x_ss,  dt_sb, dt_sh, dt_ss, a_sb,  a_sh,  a_ss,  b_sb,
                 b_sg,  b_ss,  c_sb,  c_sg,  c_ss,  y_sb,  y_sh,  y_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_p<float>(p, P, batch, st));
  if (dtype == 1) return static_cast<int>(launch_p<__nv_bfloat16>(p, P, batch, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
