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
// = h / (Hq / Hkv)), given the forward's output o, the incoming dO and the
// forward's row logsumexp (B, Hq, Sq).  P = exp(scale * q k^T - lse) (0 where
// masked) is recomputed tile by tile, with D = rowsum(dO * O) and
// dS = P * (dO V^T - D): dQ = scale * dS K, dK = scale * dS^T Q and
// dV = P^T dO, dK and dV summed over the Hq / Hkv query heads of their kv
// head.  Outputs dq, dk, dv are f32 and contiguous; FlashAttention.backward
// casts them to the input type.  A query row with no valid key has no defined forward
// output and none here either (the tests have none).  No atomics: every sum
// runs in one fixed order, so results repeat bit for bit.
//
// What bounds it on an H100: at the training shape (B 2, Hq 9, Hkv 3, S 512,
// d 64, causal, bf16) the function reads q, o, dO, k, v and lse and writes
// f32 dq, dk, dv: 8.3 MB, 2.48 us at 3.35 TB/s.  Its causal work is five
// products of 2 d operations per valid (q, k) pair, 1.51 GFLOP, 1.53 us at
// 989 TFLOP/s.  So bytes bound it, and at 2.5 us either bound is far below
// what two launches and a causal triangle of 64-row tiles leave: the design
// is about filling 132 SMs, putting the triangle's long rows first, and the
// instructions each tile issues.
//
// Two routes by input type:
//  * bf16 (the training path): tensor cores through mma.sync.m16n8k16 (bf16
//    in, f32 accumulate), P and dS rounded to bf16 for the products that take
//    them, as the forward rounds P.  Two passes, each a block of two warp
//    groups of 4 warps (16 rows a warp):
//     1. flash_bwd_dq_mma, one block per (query tile, q head, batch): it
//        computes D for its rows (and writes it for pass 2: the delta pass is
//        folded in), holds its Q and dO rows as ldmatrix A fragments in
//        registers (d <= 64; at d 128 they are read from shared memory at each
//        use, for registers), and its warp groups take the key tiles its rows
//        see in turns, each streaming them through two cp.async buffers of its
//        own (the next tile's copy in flight behind this tile's products);
//        dQ = group 0's sum + group 1's.
//     2. flash_bwd_dkdv_mma, one block per (key tile, q head, batch): the
//        group's blocks of a key tile form a thread-block cluster.  Each holds
//        its K and V rows as A fragments; its warp groups take its (head,
//        query tile) items in turns, streamed the same way; then the cluster
//        sums the f32 dK and dV of its blocks' warp groups over distributed
//        shared memory in a fixed order (rank ascending, group 0 first).  A
//        GQA group larger than the portable cluster (8) takes clusters of its
//        largest divisor up to 8, each rank looping over consecutive heads.
//    At the training shape each pass has 144 blocks (one per SM: registers),
//    against 48 for a dK/dV pass that loops over the group's heads.  The
//    grids put the causal mask's heaviest tiles in the first wave (the last
//    query tiles, the first key tiles).  P = 2^(s scale log2e - lse log2e)
//    on ex2.approx; only the tiles that cut the mask compare per element,
//    against each row's (or key's) valid range.  S and dP are computed in
//    both passes (seven products for five): that buys the blocks and the
//    absence of atomics.  Each of these choices was timed in turns against
//    the design without it (DESIGN_TORCH.md section 13).
//  * f32: plain FMA on the CUDA cores, all in f32, q scaled before the
//    product as in the reference, in three passes (the delta pass, a dK/dV
//    pass over the group's heads, a dQ pass), through shared memory.
//
// Head dims 32, 64, 100, 112 and 128.  d 112 (zamba2's shared attention,
// 3584 / 32) is a whole number of k-steps and of 16-byte chunks (rows of 224
// bytes): it takes the tiles, shared memory and registers that d 100 takes
// and needs no padding.  The bf16 route's k-steps take 16 columns,
// so d 100 (llama-3b) runs as 112 in shared memory: its tiles' copies read
// the 100 columns of each row (the last 16-byte chunk only its 8 valid
// bytes) and zero-fill columns 100-111, which then add nothing to S = Q K^T
// or dP = dO V^T; the padding columns of dQ, dK and dV (zeros) are not
// stored, and the outputs keep the row pitch d.  The cp.async copies take
// rows that start on 16 bytes: the wrapper gives q, k, v, o and dO at d 100
// in rows padded to 104 elements (kernels/flash_attention.py, tma_ready).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// ---------------------------------------------------------------------------
// f32 route, pass 1: D = rowsum(dO * O), one warp per query row
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256) flash_bwd_delta(Params p, int d) {
  const int r = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  if (r >= p.Sq) return;
  const float* orow = static_cast<const float*>(p.o) + b * p.o_sb + h * p.o_sh + r * p.o_ss;
  const float* drow = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh + r * p.do_ss;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc += orow[c] * drow[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[((long long)b * p.Hq + h) * p.Sq + r] = acc;
}

// ---------------------------------------------------------------------------
// bf16 route: mma.sync tensor cores, 64-row tiles, one warp per 16 rows
// ---------------------------------------------------------------------------

constexpr int kMmaB = 64;  // rows of every tile (queries or keys)
constexpr int kMaxCluster = 8;  // the portable cluster size

constexpr int kGroups = 2;                  // warp groups of a bf16 block (the code takes 2)
constexpr int kMmaThreads = kGroups * 128;  // each group 4 warps, 16 rows a warp

// DL: the head dim of the tensors; D: the width the tiles hold in shared
// memory, DL rounded up to the k-step of 16 (d 100 -> 112).  The columns
// from DL to D arrive as zeros (tile_async), so they add nothing to S or
// dP, and their dQ, dK and dV columns (zeros too) are never stored.
template <int DL>
struct MmaTile {
  static constexpr int D = (DL + 15) / 16 * 16;
  static_assert(DL % 4 == 0, "rows end on a whole 8-byte chunk");
  static constexpr int LD = D + 8;  // bf16 row pitch: the 8 rows of an ldmatrix on distinct banks
  static constexpr int TILE = kMmaB * LD * 2;  // bytes of one tile
  static constexpr int ROWS = 2 * kMmaB * 4;   // a buffer's lse and delta rows (dK/dV pass)
  // Two own tiles; per warp group two buffers of two streamed tiles and
  // their rows.  The end of each pass reuses the space for the groups' f32
  // partials (the dK/dV pass: dK and dV, 2 x 64 x D floats per group).
  static constexpr int SMEM = (2 + 4 * kGroups) * TILE + 2 * kGroups * ROWS;
  static constexpr bool kHold = D <= 64;  // own tile's A fragments held in registers
  static_assert(kGroups * 2 * kMmaB * D * 4 <= SMEM, "the partials fit in the tiles' space");
};

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error about 2^-22; P is
// rounded to bf16 for the products that take it)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Every (query, key) pair of the 64 x 64 tile pair at (q0, k0) is valid, so
// its scores need no per-element mask.
__device__ __forceinline__ bool tile_all_valid(const Params& p, int q0, int k0) {
  bool ok = q0 + kMmaB <= p.Sq && k0 + kMmaB <= p.k_len;
  if (p.causal) ok = ok && q0 >= k0 + kMmaB - 1;
  if (p.window > 0) ok = ok && q0 + kMmaB - 1 - k0 < p.window;
  return ok;
}

// The keys [lo, hi) that query row r sees (empty past Sq): pair_valid as a
// range, so a masked tile costs two compares per element.
__device__ __forceinline__ void row_key_range(const Params& p, int r, int& lo, int& hi) {
  hi = r < p.Sq ? p.k_len : 0;
  if (p.causal) hi = min(hi, r + 1);
  lo = p.window > 0 ? max(0, r - p.window + 1) : 0;
}

// The query rows [lo, hi) that see key c (empty past k_len).
__device__ __forceinline__ void key_query_range(const Params& p, int c, int& lo, int& hi) {
  hi = c < p.k_len ? p.Sq : 0;
  if (p.window > 0) hi = min(hi, c + p.window);
  lo = p.causal ? c : 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes (cg: through L2 only) or 4 bytes (ca) from global to shared; only
// the first src_bytes are read, the rest is zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + 64) of a (S, DL) bf16 slab with row stride ss into the
// tile at dst (D columns, pitch LD), by cp.async from threads tid of n; rows
// at or past `limit`, and columns DL to D, are zero.  Each copy moves a
// 16-byte chunk of 8 columns and reads only the chunk's bytes below DL (8
// of them in the last chunk at d 100), so no row is read past its end; the
// wrapper gives rows that start on 16 bytes.
template <int DL>
__device__ __forceinline__ void tile_async(uint32_t dst, const __nv_bfloat16* src, long long ss,
                                           int row0, int limit, int tid, int n) {
  constexpr int D = MmaTile<DL>::D;
  constexpr int VPR = D / 8;
  for (int i = tid; i < kMmaB * VPR; i += n) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    const int bytes = row0 + r < limit ? min(16, max(0, (DL - c) * 2)) : 0;
    cp_async16(dst + (r * MmaTile<DL>::LD + c) * 2, bytes ? src + (row0 + r) * ss + c : src,
               bytes);
  }
}

// 64 floats of a (Sq,) row of lse or delta from row0 into dst, by threads
// tid < 64; rows at or past `limit` are zero.
__device__ __forceinline__ void row_async(uint32_t dst, const float* src, int row0, int limit,
                                          int tid) {
  if (tid < kMmaB) {
    const bool in = row0 + tid < limit;
    cp_async4(dst + tid * 4, in ? src + row0 + tid : src, in ? 4 : 0);
  }
}

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
}

// The A fragment (16 rows x 16 columns at column kk * 16) of this warp's 16
// rows of a tile (pitch LD at `tile`), as mma.m16n8k16 takes it.
template <int D>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], uint32_t tile, int warp, int lane,
                                       int kk) {
  ldsm_x4(a, tile + ((warp * 16 + (lane % 16)) * MmaTile<D>::LD + kk * 16 + (lane / 16) * 8) * 2);
}

// An own tile's A fragments: held in registers (kHold: D <= 64, read once)
// or read from shared memory at each use (D 128, for registers).
template <int D>
struct OwnTile {
  uint32_t f[MmaTile<D>::kHold ? D / 16 : 1][4];
  uint32_t tile;
  int warp, lane;
  __device__ __forceinline__ void init(uint32_t t, int w, int l) {
    tile = t;
    warp = w;
    lane = l;
    if constexpr (MmaTile<D>::kHold) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) a_frag<D>(f[kk], tile, warp, lane, kk);
    }
  }
  __device__ __forceinline__ void get(uint32_t (&a)[4], int kk) const {
    if constexpr (MmaTile<D>::kHold) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = f[kk][e];
    } else {
      a_frag<D>(a, tile, warp, lane, kk);
    }
  }
};

// acc (16 own rows x 64 streamed rows, 8 n8 tiles) = own rows . streamed
// rows over D: S = Q K^T in the dQ pass, S^T = K Q^T in the dK/dV pass.  The
// streamed tile's B fragments come by ldmatrix (not transposed): one x4 for
// two n8 tiles and one 16-column step.
template <int D>
__device__ __forceinline__ void own_times_streamed(float (&acc)[kMmaB / 8][4],
                                                   const OwnTile<D>& own, uint32_t streamed,
                                                   int lane) {
  constexpr int LD = MmaTile<D>::LD;
#pragma unroll
  for (int j = 0; j < kMmaB / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    own.get(a, kk);
#pragma unroll
    for (int j = 0; j < kMmaB / 8; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, streamed + ((j * 8 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                             ((lane / 8) % 2) * 8) * 2);
      mma_16816(acc[j], a, b[0], b[1]);
      mma_16816(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// out (16 rows x D) += X (16 x 64: the f32 accumulators x rounded to bf16 as
// A fragments) . the 64 rows of the tile m (64 x D), whose B fragments come
// by ldmatrix.trans: dQ += dS K, dV += P^T dO, dK += dS^T Q.
template <int D>
__device__ __forceinline__ void acc_times_tile(float (&out)[D / 8][4],
                                               const float (&x)[kMmaB / 8][4], uint32_t m,
                                               int lane) {
  constexpr int LD = MmaTile<D>::LD;
#pragma unroll
  for (int kk = 0; kk < kMmaB / 16; ++kk) {
    const uint32_t a[4] = {pack_f32(x[2 * kk][0], x[2 * kk][1]),
                           pack_f32(x[2 * kk][2], x[2 * kk][3]),
                           pack_f32(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_f32(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, m + ((kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                            (n + lane / 16) * 8) * 2);
      mma_16816(out[n], a, b[0], b[1]);
      mma_16816(out[n + 1], a, b[2], b[3]);
    }
  }
}

// Pass 1 of the bf16 route: one block per (query tile, q head, batch), two
// warp groups of 4 warps, each warp 16 query rows.  The block computes D for
// its rows (written to p.delta for pass 2), every warp holds its Q and dO
// rows as A fragments, and warp group i takes the key tiles t0 + i, t0 + i +
// 2, ... that its rows see, streamed through two cp.async buffers of its own:
// the next tile's copy in flight behind this tile's products.  dQ = scale *
// (group 0's sum + group 1's sum) of dS K.
template <int DL>
__global__ void __launch_bounds__(kMmaThreads, 1) flash_bwd_dq_mma(Params p) {
  constexpr int D = MmaTile<DL>::D;
  constexpr int TILE = MmaTile<D>::TILE;
  constexpr int NS = kMmaB / 8;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t q_s = smem_u32(smem_raw);
  const uint32_t do_s = q_s + TILE;
  float* dl_s = reinterpret_cast<float*>(smem_raw + (2 + 4 * kGroups) * TILE);

  // grid (Hq, B, query tiles), the last query tile first: under a causal
  // mask the tiles that see the most keys start in the first wave
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kMmaB;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (p.Hq / p.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / 4, lw = warp % 4, gtid = threadIdx.x % 128;
  const uint32_t kv_s = do_s + TILE + grp * 4 * TILE;  // buffer i: k at kv_s + 2 i TILE, v after
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + lw * 16 + g;  // this thread's query rows r0 and r0 + 8
  const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dog =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  int t0, t1;
  key_tile_range(p, q0, kMmaB, kMmaB, t0, t1);
  tile_async<DL>(q_s, qg, p.q_ss, q0, p.Sq, threadIdx.x, kMmaThreads);
  tile_async<DL>(do_s, dog, p.do_ss, q0, p.Sq, threadIdx.x, kMmaThreads);
  cp_async_commit();
  if (t0 + grp < t1) {
    tile_async<DL>(kv_s, kg, p.k_ss, (t0 + grp) * kMmaB, p.Sk, gtid, 128);
    tile_async<DL>(kv_s + TILE, vg, p.v_ss, (t0 + grp) * kMmaB, p.Sk, gtid, 128);
  }
  cp_async_commit();

  if (threadIdx.x < 128) {  // D = rowsum(dO * O) in f32: two threads per row, 16-byte loads
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    float acc = 0.f;
    if (q0 + r < p.Sq) {
      const __nv_bfloat16* orow =
          static_cast<const __nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh + (q0 + r) * p.o_ss;
      const __nv_bfloat16* drow = dog + (q0 + r) * p.do_ss;
#pragma unroll
      for (int c = half * 8; c < DL; c += 16) {
        // 8 columns in one 16-byte load; a row whose last chunk holds 4 (d
        // 100) reads those with one 8-byte load
        const int n2 = c + 8 <= DL ? 4 : 2;
        uint4 ov, dv;
        if (n2 == 4) {
          ov = *reinterpret_cast<const uint4*>(orow + c);
          dv = *reinterpret_cast<const uint4*>(drow + c);
        } else {
          const uint2 o8 = *reinterpret_cast<const uint2*>(orow + c);
          const uint2 d8 = *reinterpret_cast<const uint2*>(drow + c);
          ov = make_uint4(o8.x, o8.y, 0u, 0u);
          dv = make_uint4(d8.x, d8.y, 0u, 0u);
        }
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (e >= n2) break;
          const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
          acc += of.x * df.x;
          acc += of.y * df.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      dl_s[r] = acc;
      if (q0 + r < p.Sq) p.delta[row_base + q0 + r] = acc;
    }
  }
  // P = exp(scale s - lse) = 2^(s scale log2e - lse log2e)
  const float sl2 = p.scale * kLog2e;
  float lse2[2];
  int klo[2], khi[2];  // the keys each of this thread's rows sees
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = r0 + 8 * i < p.Sq ? p.lse[row_base + r0 + 8 * i] * kLog2e : 0.f;
    row_key_range(p, r0 + 8 * i, klo[i], khi[i]);
  }

  cp_async_wait<1>();  // Q and dO landed (this thread's copies) ...
  __syncthreads();     // ... everyone's, and D
  OwnTile<D> qf, dof;
  qf.init(q_s, lw, lane);
  dof.init(do_s, lw, lane);
  const float dl_r[2] = {dl_s[lw * 16 + g], dl_s[lw * 16 + g + 8]};

  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  int it = 0;
  for (int kt = t0 + grp; kt < t1; kt += kGroups, ++it) {
    const int buf = it & 1;
    if (kt + kGroups < t1) {  // the group's next key tile into its other buffer
      const uint32_t nb = kv_s + 2 * (buf ^ 1) * TILE;
      tile_async<DL>(nb, kg, p.k_ss, (kt + kGroups) * kMmaB, p.Sk, gtid, 128);
      tile_async<DL>(nb + TILE, vg, p.v_ss, (kt + kGroups) * kMmaB, p.Sk, gtid, 128);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this key tile landed (this thread's copies) ...
    group_sync(grp);     // ... the group's
    const uint32_t k_t = kv_s + 2 * buf * TILE, v_t = k_t + TILE;
    const int k0 = kt * kMmaB;

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x 64 keys
    float s[NS][4], dp[NS][4];
    own_times_streamed<D>(s, qf, k_t, lane);
    own_times_streamed<D>(dp, dof, v_t, lane);
    // P in s; the per-element mask only on tiles that need one (a uniform
    // branch: the mask's integer work would otherwise dominate the issue)
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = fast_exp2(fmaf(s[j][e], sl2, -lse2[e >> 1]));
    if (!tile_all_valid(p, q0, k0)) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = k0 + j * 8 + 2 * t + (e & 1);
          if (c < klo[e >> 1] || c >= khi[e >> 1]) s[j][e] = 0.f;
        }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - dl_r[e >> 1]);
    acc_times_tile<D>(dq, dp, k_t, lane);  // dQ += dS K
    group_sync(grp);  // the group is done with this buffer before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();  // both groups are done: the tiles' space takes group 1's dQ

  float* part = reinterpret_cast<float*>(smem_raw);  // [64][D]: group 1's dQ
  if (grp == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = lw * 16 + g + 8 * i;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(part + row * D + n * 8 + 2 * t) =
            make_float2(dq[n][2 * i], dq[n][2 * i + 1]);
    }
  }
  __syncthreads();
  if (grp != 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= p.Sq) continue;
    const int row = lw * 16 + g + 8 * i;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (n * 8 + 2 * t >= DL) continue;  // a padding column: never stored
      const float2 other = *reinterpret_cast<const float2*>(part + row * D + n * 8 + 2 * t);
      const long long off = (row_base + r) * DL + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(p.dq + off) = make_float2((dq[n][2 * i] + other.x) * p.scale,
                                                           (dq[n][2 * i + 1] + other.y) * p.scale);
    }
  }
}

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

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// Pass 2 of the bf16 route: one block per (key tile, q head, batch), two
// warp groups of 4 warps, each warp 16 keys; the group's blocks of one key
// tile form a thread-block cluster of cs blocks (cs the largest divisor of
// the group up to 8).  Cluster rank r takes the group's heads r * m .. r * m
// + m - 1 (m = group / cs); its (head, query tile) items, head-major, go to
// its warp groups in turn (item i to group i % 2), streamed -- Q, dO, lse,
// delta -- through two cp.async buffers per warp group, while every warp
// holds its K and V rows as A fragments: dV = sum P^T dO and dK = scale *
// sum dS^T Q.  Then the cluster sums the f32 dK and dV of its blocks' warp
// groups over distributed shared memory, rank by rank in ascending order and
// group 0 before group 1 within a rank, each rank a share of the elements:
// every dK, dV element is the same sum in the same order on every launch.
template <int DL>
__global__ void __launch_bounds__(kMmaThreads, 1) flash_bwd_dkdv_mma(Params p, int cs) {
  constexpr int D = MmaTile<DL>::D;
  constexpr int TILE = MmaTile<D>::TILE;
  constexpr int ROWS = MmaTile<D>::ROWS;
  constexpr int NS = kMmaB / 8;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t k_s = smem_u32(smem_raw);
  const uint32_t v_s = k_s + TILE;

  // grid (Hkv cs, B, key tiles), clusters along x: under a causal mask the
  // first key tiles, which the most query tiles see, start in the first wave
  const int k0 = blockIdx.z * kMmaB;
  const int b = blockIdx.y;
  const unsigned rank = cluster_rank();
  const int hk = blockIdx.x / cs;
  const int group = p.Hq / p.Hkv;
  const int n_heads = group / cs;
  const int h0 = hk * group + rank * n_heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / 4, lw = warp % 4, gtid = threadIdx.x % 128;
  // the group's buffers: i holds q at qd_s + 2 i TILE and dO after it, its
  // lse at rows_s + i ROWS and its delta 256 bytes further
  const uint32_t qd_s = v_s + TILE + grp * 4 * TILE;
  const int rows_off = (2 + 4 * kGroups) * TILE + grp * 2 * ROWS;
  const uint32_t rows_s = k_s + rows_off;
  const float* rows_f = reinterpret_cast<const float*>(smem_raw + rows_off);
  const int g = lane >> 2, t = lane & 3;
  const int c0 = k0 + lw * 16 + g;  // this thread's key rows c0 and c0 + 8
  const float sl2 = p.scale * kLog2e;  // P = 2^(s scale log2e - lse log2e)
  int qlo[2], qhi[2];  // the query rows that see each of this thread's keys
#pragma unroll
  for (int i = 0; i < 2; ++i) key_query_range(p, c0 + 8 * i, qlo[i], qhi[i]);

  int t0, t1;
  query_tile_range(p, k0, kMmaB, kMmaB, t0, t1);
  const int n_tiles = t1 - t0;
  const int n_items = n_heads * n_tiles;  // (head, query tile), head-major

  auto issue = [&](int item, int buf) {
    const int h = h0 + item / n_tiles;
    const int q0 = (t0 + item % n_tiles) * kMmaB;
    const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
    const uint32_t qb = qd_s + 2 * buf * TILE;
    tile_async<DL>(qb, static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
                   q0, p.Sq, gtid, 128);
    tile_async<DL>(qb + TILE,
                  static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh,
                  p.do_ss, q0, p.Sq, gtid, 128);
    row_async(rows_s + buf * ROWS, p.lse + row_base, q0, p.Sq, gtid);
    row_async(rows_s + buf * ROWS + 256, p.delta + row_base, q0, p.Sq, gtid);
  };

  tile_async<DL>(k_s, static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss,
                 k0, p.Sk, threadIdx.x, kMmaThreads);
  tile_async<DL>(v_s, static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss,
                 k0, p.Sk, threadIdx.x, kMmaThreads);
  cp_async_commit();
  if (grp < n_items) issue(grp, 0);
  cp_async_commit();

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  cp_async_wait<1>();  // K and V landed (this thread's copies) ...
  __syncthreads();     // ... everyone's
  OwnTile<D> kf, vf;
  kf.init(k_s, lw, lane);
  vf.init(v_s, lw, lane);

  int it = 0;
  for (int item = grp; item < n_items; item += kGroups, ++it) {
    const int buf = it & 1;
    if (item + kGroups < n_items) issue(item + kGroups, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this item's tiles landed (this thread's copies) ...
    group_sync(grp);     // ... the group's
    const int q0 = (t0 + item % n_tiles) * kMmaB;
    const uint32_t q_t = qd_s + 2 * buf * TILE, do_t = q_t + TILE;
    const float* lse_s = rows_f + buf * (ROWS / 4);
    const float* dl_s = lse_s + kMmaB;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 queries
    float s[NS][4], dp[NS][4];
    own_times_streamed<D>(s, kf, q_t, lane);
    own_times_streamed<D>(dp, vf, do_t, lane);
    // P^T in s; the per-element mask only on tiles that need one
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = fast_exp2(fmaf(s[j][e], sl2, -lse_s[j * 8 + 2 * t + (e & 1)] * kLog2e));
    if (!tile_all_valid(p, q0, k0)) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + j * 8 + 2 * t + (e & 1);
          if (q < qlo[e >> 1] || q >= qhi[e >> 1]) s[j][e] = 0.f;
        }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - dl_s[j * 8 + 2 * t + (e & 1)]);
    acc_times_tile<D>(dv, s, do_t, lane);   // dV += P^T dO
    acc_times_tile<D>(dk, dp, q_t, lane);   // dK += dS^T Q
    group_sync(grp);  // the group is done with this buffer before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();  // the tiles' space becomes the groups' f32 dK, dV

  // [group][dK, dV][64][D]
  float* red = reinterpret_cast<float*>(smem_raw) + grp * 2 * kMmaB * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = lw * 16 + g + 8 * i;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * t;
      *reinterpret_cast<float2*>(red + row * D + col) = make_float2(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<float2*>(red + (kMmaB + row) * D + col) =
          make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
  cluster_sync();

  // rank r sums the float4 chunks r * 256 + tid (+ cs * 256 ...) of dK and
  // dV, over the ranks in ascending order and each rank's groups in order
  const long long kv_base = ((long long)b * p.Hkv + hk) * p.Sk;
  const uint32_t red_s = smem_u32(smem_raw);
  constexpr int kChunks = 2 * kMmaB * D / 4;
  for (int c = rank * kMmaThreads + threadIdx.x; c < kChunks; c += cs * kMmaThreads) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int rr = 0; rr < cs; ++rr) {
#pragma unroll
      for (int gg = 0; gg < kGroups; ++gg) {
        const float4 v = ld_cluster_f4(red_s + (gg * kChunks + c) * 16, rr);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
    }
    const int e = c * 4;
    const bool is_dv = e >= kMmaB * D;
    const int row = (e / D) % kMmaB, col = e % D;
    if (k0 + row >= p.Sk || col >= DL) continue;  // past Sk, or a padding column
    const long long off = (kv_base + k0 + row) * DL + col;
    if (is_dv) {
      *reinterpret_cast<float4*>(p.dv + off) = sum;
    } else {
      *reinterpret_cast<float4*>(p.dk + off) =
          make_float4(sum.x * p.scale, sum.y * p.scale, sum.z * p.scale, sum.w * p.scale);
    }
  }
  cluster_sync();  // no block leaves while another still reads its shared memory
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
// The f32 route's passes 2 and 3, and the launches of both routes
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_f32(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  dkdv_f32<D>(p, smem_raw);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  dq_f32<D>(p, smem_raw);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory, once per device
// (the host's time per launch counts at the training shape).
template <auto kernel>
cudaError_t allow_smem(int smem) {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <auto kernel, typename... Args>
cudaError_t launch(dim3 grid, int threads, int smem, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// bf16: the dQ pass (which also writes delta), then the dK/dV pass in
// clusters of the largest divisor of the group up to kMaxCluster.  DL: the
// tensors' head dim.
template <int DL>
cudaError_t run_mma(const Params& p, cudaStream_t st) {
  constexpr int smem = MmaTile<DL>::SMEM;
  cudaError_t err =
      launch<flash_bwd_dq_mma<DL>>(dim3(p.Hq, p.B, (p.Sq + kMmaB - 1) / kMmaB), kMmaThreads,
                                  smem, st, p);
  if (err != cudaSuccess) return err;
  const int group = p.Hq / p.Hkv;
  int cs = kMaxCluster;
  while (group % cs) --cs;
  err = allow_smem<flash_bwd_dkdv_mma<DL>>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.Hkv * cs, p.B, (p.Sk + kMmaB - 1) / kMmaB);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_mma<DL>, p, cs);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// f32: the delta pass, the dK/dV pass over the group's heads, the dQ pass.
template <int D>
cudaError_t run_f32(const Params& p, cudaStream_t st) {
  constexpr int smem = SimtTile<D>::SMEM;
  flash_bwd_delta<<<dim3((p.Sq + 7) / 8, p.Hq, p.B), 256, 0, st>>>(p, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch<flash_bwd_dkdv_f32<D>>(dim3((p.Sk + kSimtB - 1) / kSimtB, p.Hkv, p.B), kThreads,
                                      smem, st, p);
  if (err != cudaSuccess) return err;
  return launch<flash_bwd_dq_f32<D>>(dim3((p.Sq + kSimtB - 1) / kSimtB, p.Hq, p.B), kThreads,
                                     smem, st, p);
}

}  // namespace

extern "C" {

// The arguments come packed in one array of 35 int64 (the wrapper's host
// time per call matters at the training shape), in this order:
//  0-9    pointers q, k, v, o, dout, lse, delta, dq, dk, dv;
//  10-16  dtype (0 = float32, 1 = bfloat16: q, k, v, o, dout alike), B, Hq,
//         Hkv, Sq, Sk, d (32, 64, 100, 112 or 128);
//  17-31  element strides (batch, head, row) of q, k, v, o, dout;
//  32-34  causal, window, k_len.
// lse: the forward's (B, Hq, Sq) f32; delta: (B, Hq, Sq) f32 scratch; dq
// (B, Hq, Sq, d), dk and dv (B, Hkv, Sk, d): f32, contiguous.  Launches the
// passes on `stream` in order (two for bf16, three for f32); returns the
// first CUDA error (0 on success).  Nothing is synchronised here.
int flash_attention_bwd(const long long* a, float scale, void* stream) {
  auto ptr = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  const int dtype = static_cast<int>(a[10]), d = static_cast<int>(a[16]);
  const Params p{ptr(0),  ptr(1),  ptr(2),  ptr(3),  ptr(4),
                 static_cast<const float*>(ptr(5)), static_cast<float*>(ptr(6)),
                 static_cast<float*>(ptr(7)), static_cast<float*>(ptr(8)),
                 static_cast<float*>(ptr(9)),
                 static_cast<int>(a[11]), static_cast<int>(a[12]), static_cast<int>(a[13]),
                 static_cast<int>(a[14]), static_cast<int>(a[15]),
                 a[17], a[18], a[19], a[20], a[21], a[22], a[23], a[24], a[25],
                 a[26], a[27], a[28], a[29], a[30], a[31],
                 static_cast<int>(a[32]), static_cast<int>(a[33]), static_cast<int>(a[34]),
                 scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (d) {
      case 32: return run_mma<32>(p, st);
      case 64: return run_mma<64>(p, st);
      case 100: return run_mma<100>(p, st);
      case 112: return run_mma<112>(p, st);
      case 128: return run_mma<128>(p, st);
    }
  } else if (dtype == 0) {
    switch (d) {
      case 32: return run_f32<32>(p, st);
      case 64: return run_f32<64>(p, st);
      case 100: return run_f32<100>(p, st);
      case 112: return run_f32<112>(p, st);
      case 128: return run_f32<128>(p, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
