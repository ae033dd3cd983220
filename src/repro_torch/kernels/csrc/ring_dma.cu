// Fused ring reduce-scatter and all-gather for Hopper (sm_90a), with a plain C
// interface that kernels/ring_dma.py loads through ctypes.
//
// Replace src/repro/kernels/ring_dma.py::_rs_dma_kernel and ::_ag_dma_kernel,
// the Pallas TPU kernels of the backend="pallas" cross-island rings.  Same
// functions and the same ring schedule: each ring step's payload is split
// into kNumBuffers streams and n_stripes stripes ("pieces"), each with its
// own flag per step parity; a rank credits its neighbour once it has
// drained a buffer of that parity, and the neighbour takes that credit
// before it reuses the buffer two steps later.  Credits are only issued
// where a matching wait exists.  The reduce-scatter keeps an f32
// accumulator and puts the running partial on the wire in the wire dtype,
// rounded to nearest even at every step, exactly where the reference's
// emulated schedule casts, so the sums come out bit for bit as there.
//
// One launch covers every rank of the mesh that shares this device: grid
// (ctas, R).  CTA k of rank r owns the contiguous column slice k of every
// chunk and runs the whole ring protocol for that slice with CTA k of its
// neighbours, so CTAs of one rank never wait for each other.  A flag is set
// by a fence and a release store after the CTA's writes; a waiter spins on
// it with acquire loads and then reads the data around L1.  Because CTAs
// wait for CTAs of other ranks, every CTA of the launch must be resident at
// once: the launch is cooperative and fails if the grid does not fit.
// Every wait gives up after kSpinTimeoutNs of %globaltimer, writes the
// error word and returns, and every other wait then stops too: a protocol
// fault becomes an error that the wrapper raises, not a hung card.  Flags
// carry a per-call tag (seq, step), so the buffers are reused across calls
// without a memset.
//
// The reduce-scatter pulls.  At step s rank r reads its upstream rank's
// payload in place (the input chunk at s = 0, else the upstream's f32
// partial of step s - 1), rounds it to the wire type, adds its own input
// chunk in f32 and writes its own partial (parity s & 1), or the output at
// the last step.  The upstream sets one "partial written" flag per piece
// and parity; the reader waits on it (s >= 1; inputs are ready at launch)
// and credits the upstream once it has read that parity, and the upstream
// takes the credit before it overwrites the parity two steps later.  No
// slot is written: a rank moves 3c elements per step (read the payload,
// read its own chunk, write), where storing into a receive slot moved 5c.
// On the per-rank route below (ROADMAP A3) the partial's read is a peer load.
//
// What bounds it on an H100: no arithmetic to speak of, so device memory;
// one card's "wire" is HBM, so these kernels time the protocol plus HBM
// traffic, not a link.  The copies move 16-byte vectors with several in
// flight per thread (loads around L1 with an L2 256-byte prefetch hint,
// streaming stores), with a scalar head and tail where a piece's bounds fall
// inside a vector.  The reduce-scatter works in units of eight elements
// keyed to its f32 destination's alignment; a source whose address is not
// 16-byte aligned at a unit (an input row of an odd c) takes the unit as
// scalar loads; bf16 sources unpack eight values per vector.  The
// all-gather's step 0 reads the input once and writes both the own output
// row and the downstream slot, so no staging copy into the own slot is
// made: at n = 2 a rank reads 2c and writes 3c elements.  Slots and
// partials lie `pitch` elements apart, c rounded up to a whole number of
// 16-byte vectors, so every one starts 16-byte aligned.  No TMA,
// cp.async.bulk or multimem stores yet.
//
// Per-rank launches over peer memory (ROADMAP A3; DESIGN_TORCH.md §28).  A
// rank of a DistMesh (one process per rank, on one card or several) launches
// its own part, grid (ctas), as the reference runs one kernel instance per
// device.  Each process owns an arena (cudaMalloc, exported with
// cudaIpcGetMemHandle; kernels/peer.py) holding its flags, error word, f32
// partials and slots, and maps its two neighbours' arenas.  A flag lives in
// the arena of the rank that waits on it and is set by a remote release
// store, so every spin reads local memory; flags are acquired and released
// at .sys scope.  Each CTA first posts a ready tag (seq, call signature,
// ring position) to both neighbours and waits for theirs before it touches
// peer memory: a neighbour still in its previous call is never overwritten,
// and two processes whose calls differ in order or shape stop with
// kErrOrder instead of summing wrong data.  Ready tags alternate between two
// slots by seq parity, since a neighbour can be at most one call ahead.
// The reduce-scatter's pull cannot read the upstream's input in place
// across processes (the input's owner may free it once its own part is
// done), so each rank first stages the one chunk its downstream reads at
// step 0 into its f32 partial of parity 1 ("step -1", set like a partial,
// credited like one): 8c more bytes a call and rank, the same sums.  Every
// wait stays bounded by kSpinTimeoutNs; a rank that gives up writes its own
// and both neighbours' error words, so a fault stops the ring.  On one card
// without MPS the processes' kernels are time-sliced: a hand-off waits for
// the spinning context's slice to end (a flag passed round a ring of
// spinning processes took 2.26 ms a hand-off with two processes and 4.50 ms
// with four, the longest wait 18 ms, on an NVIDIA H100 80GB HBM3 at
// 700.00 W; PERF.md §6), which the bound covers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kNumBuffers = 2;    // ring_dma.NUM_BUFFERS
constexpr int kMaxStripes = 8;    // transport.stripe.MAX_STRIPES
constexpr int kMaxRanks = 64;
constexpr int kThreads = 512;
constexpr unsigned long long kSpinTimeoutNs = 2000000000ull;
constexpr int kErrData = 1;       // a slot's or a partial's data flag never came
constexpr int kErrCredit = 2;     // a credit never came

struct Ring {
  int R, n, direction, stripes, ctas;
  long long c;                         // elements per chunk
  long long pitch;                     // elements from one slot (all-gather) or f32 partial
                                       // (reduce-scatter) to the next: >= c, 16-byte multiple
  int pos[kMaxRanks];                  // position of each rank in its ring
  int dst[kMaxRanks];                  // downstream neighbour (global rank)
  int src[kMaxRanks];                  // upstream neighbour
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
  void* slots;                         // [R][2][pitch] (all-gather)
  float* acc;                          // [R][2][pitch] f32 partials (reduce-scatter)
  unsigned long long* data_flags;      // [R][2][kNumBuffers][kMaxStripes][ctas]
  unsigned long long* cap_flags;       // [R][2][ctas]
  int* err;                            // code, rank, step, cta
  unsigned long long seq;              // this call's tag
};

__device__ __forceinline__ unsigned long long tag(const Ring& g, int s) {
  return g.seq * 65536ull + (unsigned long long)(s + 1);
}

__device__ __forceinline__ int wrap(int a, int n) { return ((a % n) + n) % n; }

__device__ __forceinline__ unsigned long long* data_flag(const Ring& g, int rank, int par,
                                                         int b, int j, int k) {
  return g.data_flags +
         ((((long long)rank * 2 + par) * kNumBuffers + b) * kMaxStripes + j) * g.ctas + k;
}

__device__ __forceinline__ unsigned long long* cap_flag(const Ring& g, int rank, int par, int k) {
  return g.cap_flags + ((long long)rank * 2 + par) * g.ctas + k;
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Every thread's stores of this CTA, then the flag: fence, release store.
__device__ __forceinline__ void cta_signal(unsigned long long* flag, unsigned long long v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(flag, v);
  }
}

// Thread 0 spins until *flag == want, bounded in time; true for the whole CTA
// if it came.  On a timeout the first CTA to give up records where; every
// other wait sees the error word and stops at once.
__device__ bool cta_wait(const Ring& g, const unsigned long long* flag, unsigned long long want,
                         int code, int rank, int step) {
  int ok = 1;
  if (threadIdx.x == 0) {
    const unsigned long long t0 = globaltimer();
    while (ld_acquire(flag) != want) {
      if (*(volatile int*)g.err != 0) { ok = 0; break; }
      if (globaltimer() - t0 > kSpinTimeoutNs) {
        if (atomicCAS(g.err, 0, code) == 0) {
          g.err[1] = rank;
          g.err[2] = step;
          g.err[3] = blockIdx.x;
          __threadfence();
        }
        ok = 0;
        break;
      }
    }
    __threadfence();
  }
  return __syncthreads_and(ok);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename W> __device__ __forceinline__ W to_wire(float v);
template <> __device__ __forceinline__ float to_wire<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 to_wire<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Bounds of piece p of [lo, hi) cut into `pieces` contiguous parts.
__device__ __forceinline__ long long cut(long long lo, long long hi, int p, int pieces) {
  return lo + (hi - lo) * p / pieces;
}

constexpr int kUnroll = 4;        // all-gather: 16-byte vectors in flight per thread
constexpr int kRsUnroll = 2;      // reduce-scatter: units of eight elements in flight per thread

// 16 bytes around L1 (ld.global.cg), asking L2 to fetch the whole 256-byte
// block (on an H100 this beat the same load without the hint).
__device__ __forceinline__ uint4 ld_cg_256(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.cg.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

// dst[k][e] = src[e] for e in [a, b) and each of the ND destinations, by the
// whole CTA.  Loads go around L1 (a slot is written by another CTA).  Scalar
// until src is 16-byte aligned, then kUnroll 16-byte vectors per thread per
// round (all loaded, through ld_cg_256, before any is stored), then a scalar
// tail; a destination not aligned with src mod 16 takes each vector as V
// scalar stores.  Vector stores are streaming (st.global.cs, evict first):
// on an H100 that beat plain stores, and plain stores to the slots with the
// copy-out read backwards (to meet the slot's last lines in L2).
template <typename T, int ND>
__device__ __forceinline__ void copy_piece(T* const (&dst)[ND], const T* src, long long a,
                                           long long b) {
  constexpr int V = 16 / sizeof(T);
  const long long mis = (reinterpret_cast<uintptr_t>(src + a) % 16) / sizeof(T);
  const long long head = min(b - a, mis ? V - mis : 0ll);
  for (long long e = a + threadIdx.x; e < a + head; e += blockDim.x) {
    const T v = __ldcg(src + e);
#pragma unroll
    for (int k = 0; k < ND; ++k) dst[k][e] = v;
  }
  const long long v0 = a + head;                // first element of the vector body
  const long long nv = (b - v0) / V;            // whole vectors
  const uint4* sv = reinterpret_cast<const uint4*>(src + v0);
  bool vec[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) vec[k] = reinterpret_cast<uintptr_t>(dst[k] + v0) % 16 == 0;
  for (long long i0 = threadIdx.x; i0 < nv; i0 += (long long)kUnroll * blockDim.x) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + (long long)u * blockDim.x;
      if (i < nv) r[u] = ld_cg_256(sv + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + (long long)u * blockDim.x;
      if (i >= nv) break;
#pragma unroll
      for (int k = 0; k < ND; ++k) {
        T* d = dst[k] + v0 + i * V;
        if (vec[k]) {
          __stcs(reinterpret_cast<uint4*>(d), r[u]);
        } else {
          const T* w = reinterpret_cast<const T*>(&r[u]);
#pragma unroll
          for (int q = 0; q < V; ++q) d[q] = w[q];
        }
      }
    }
  }
  for (long long e = v0 + nv * V + threadIdx.x; e < b; e += blockDim.x) {
    const T v = __ldcg(src + e);
#pragma unroll
    for (int k = 0; k < ND; ++k) dst[k][e] = v;
  }
}

// Eight elements of a reduce-scatter stream from p into v, as f32: one or
// two 16-byte vectors when `vec` (the address is 16-byte aligned), else
// scalar loads; all around L1 (a partial is written by another CTA).
__device__ __forceinline__ void load8(float (&v)[8], const float* p, bool vec) {
  if (vec) {
    const uint4 a = ld_cg_256(reinterpret_cast<const uint4*>(p));
    const uint4 b = ld_cg_256(reinterpret_cast<const uint4*>(p + 4));
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = __uint_as_float(w[q]);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = __ldcg(p + q);
  }
}

__device__ __forceinline__ void load8(float (&v)[8], const __nv_bfloat16* p, bool vec) {
  if (vec) {
    const uint4 a = ld_cg_256(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = __uint_as_float(w[q] << 16);             // the lower address
      v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = to_float(__ldcg(p + q));
  }
}

// One element of a reduce-scatter step: the own chunk plus the upstream
// payload rounded to the wire type, in f32.
template <typename Wire>
__device__ __forceinline__ float add_hop(float own, float payload) {
  return own + to_float(to_wire<Wire>(payload));
}

// dst[e] = x[e] + wire(up[e]) for e in [a, b), by the whole CTA: up is the
// upstream rank's payload (its input row or its f32 partial), x the own
// input row, dst the own f32 partial or output.  Scalar until dst is 16-byte
// aligned, then units of eight elements, kRsUnroll units per thread per round
// (all loaded before any is stored), then a scalar tail.  A source takes
// its units as vectors where its address is 16-byte aligned at the unit
// start, else as scalar loads.  Stores are streaming (st.global.cs).
template <typename Wire, typename U, typename X>
__device__ __forceinline__ void reduce_piece(float* dst, const U* up, const X* x, long long a,
                                             long long b) {
  constexpr int V = 8;
  const long long mis = (reinterpret_cast<uintptr_t>(dst + a) % 16) / 4;
  const long long head = min(b - a, mis ? 4 - mis : 0ll);
  for (long long e = a + threadIdx.x; e < a + head; e += blockDim.x)
    dst[e] = add_hop<Wire>(to_float(x[e]), to_float(__ldcg(up + e)));
  const long long v0 = a + head;                // first element of the unit body
  const long long nv = (b - v0) / V;            // whole units
  const bool vu = reinterpret_cast<uintptr_t>(up + v0) % 16 == 0;
  const bool vx = reinterpret_cast<uintptr_t>(x + v0) % 16 == 0;
  for (long long i0 = threadIdx.x; i0 < nv; i0 += (long long)kRsUnroll * blockDim.x) {
    float pu[kRsUnroll][V], px[kRsUnroll][V];
#pragma unroll
    for (int u = 0; u < kRsUnroll; ++u) {
      const long long i = i0 + (long long)u * blockDim.x;
      if (i < nv) {
        load8(pu[u], up + v0 + i * V, vu);
        load8(px[u], x + v0 + i * V, vx);
      }
    }
#pragma unroll
    for (int u = 0; u < kRsUnroll; ++u) {
      const long long i = i0 + (long long)u * blockDim.x;
      if (i >= nv) break;
      float o[V];
#pragma unroll
      for (int q = 0; q < V; ++q) o[q] = add_hop<Wire>(px[u][q], pu[u][q]);
      float4* dv = reinterpret_cast<float4*>(dst + v0 + i * V);
      __stcs(dv, make_float4(o[0], o[1], o[2], o[3]));
      __stcs(dv + 1, make_float4(o[4], o[5], o[6], o[7]));
    }
  }
  for (long long e = v0 + nv * V + threadIdx.x; e < b; e += blockDim.x)
    dst[e] = add_hop<Wire>(to_float(x[e]), to_float(__ldcg(up + e)));
}

template <typename In, typename Wire>
__global__ void __launch_bounds__(kThreads, 2) ring_rs_kernel(const Ring g) {
  const int r = blockIdx.y, k = blockIdx.x;
  const int n = g.n, d = g.direction, my = g.pos[r], S = g.stripes, up = g.src[r];
  const long long c = g.c;
  const long long lo = c * k / g.ctas, hi = c * (k + 1) / g.ctas;
  const int pieces = kNumBuffers * S;
  const In* x = static_cast<const In*>(g.in[r]);
  const In* x_up = static_cast<const In*>(g.in[up]);
  float* out = static_cast<float*>(g.out[r]);
  float* acc = g.acc + (long long)r * 2 * g.pitch;
  const float* acc_up = g.acc + (long long)up * 2 * g.pitch;

  for (int s = 0; s < n - 1; ++s) {
    const int par = s & 1;
    const bool last = s == n - 2;
    // the chunk whose partial the upstream rank holds after step s - 1
    const long long recv = (long long)wrap(my - d * (s + 2), n) * c;
    // the downstream rank read this parity's partial of step s - 2 at step s - 1
    if (s >= 2 && !last && !cta_wait(g, cap_flag(g, r, par, k), tag(g, s - 2), kErrCredit, r, s))
      return;
    float* dst = last ? out : acc + par * g.pitch;
    for (int p = 0; p < pieces; ++p) {
      const long long p0 = cut(lo, hi, p, pieces), p1 = cut(lo, hi, p + 1, pieces);
      if (s == 0) {
        reduce_piece<Wire>(dst, x_up + recv, x + recv, p0, p1);
      } else {
        if (!cta_wait(g, data_flag(g, up, par ^ 1, p / S, p % S, k), tag(g, s - 1), kErrData, r,
                      s))
          return;
        reduce_piece<Wire>(dst, acc_up + (par ^ 1) * g.pitch, x + recv, p0, p1);
      }
      if (!last) cta_signal(data_flag(g, r, par, p / S, p % S, k), tag(g, s));
    }
    // the upstream's partial of step s - 1 is read: it may overwrite that
    // parity at step s + 1, where it waits for this credit
    if (s >= 1 && s + 1 <= n - 3) cta_signal(cap_flag(g, up, par ^ 1, k), tag(g, s - 1));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ring_ag_kernel(const Ring g) {
  const int r = blockIdx.y, k = blockIdx.x;
  const int n = g.n, d = g.direction, my = g.pos[r], S = g.stripes;
  const long long c = g.c;
  const long long lo = c * k / g.ctas, hi = c * (k + 1) / g.ctas;
  const T* x = static_cast<const T*>(g.in[r]);
  T* out = static_cast<T*>(g.out[r]);
  const T* slot_me = static_cast<const T*>(g.slots) + (long long)r * 2 * g.pitch;
  T* slot_dst = static_cast<T*>(g.slots) + (long long)g.dst[r] * 2 * g.pitch;

  for (int s = 0; s < n - 1; ++s) {
    const int par = s & 1, nxt = par ^ 1;
    // the downstream rank drained its slot nxt at step s - 1
    if (s >= 1 && !cta_wait(g, cap_flag(g, r, nxt, k), tag(g, s - 1), kErrCredit, r, s)) return;
    for (int j = 0; j < S; ++j) {
      const long long p0 = cut(lo, hi, j, S), p1 = cut(lo, hi, j + 1, S);
      if (s == 0) {
        // the own chunk, read once: into the own output row and downstream
        T* const to[2] = {out + my * c, slot_dst + nxt * g.pitch};
        copy_piece(to, x, p0, p1);
      } else {
        T* const to[1] = {slot_dst + nxt * g.pitch};
        copy_piece(to, slot_me + par * g.pitch, p0, p1);
      }
      cta_signal(data_flag(g, g.dst[r], nxt, 0, j, k), tag(g, s));
    }
    // slot par is sent and was copied out at step s - 1: upstream may write it
    if (s < n - 2) cta_signal(cap_flag(g, g.src[r], par, k), tag(g, s));
    const long long from = (long long)wrap(my - d * (s + 1), n) * c;
    for (int j = 0; j < S; ++j) {
      if (!cta_wait(g, data_flag(g, r, nxt, 0, j, k), tag(g, s), kErrData, r, s)) return;
      T* const to[1] = {out + from};
      copy_piece(to, slot_me + nxt * g.pitch, cut(lo, hi, j, S), cut(lo, hi, j + 1, S));
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Per-rank route: one launch per rank over peer-mapped arenas.
// ---------------------------------------------------------------------------

constexpr int kErrReady = 3;      // a neighbour never posted its start tag
constexpr int kErrOrder = 4;      // a neighbour's start tag names another call

struct PeerRing {
  int n, direction, stripes, ctas;
  int my, rank;                              // ring position; global rank (for the error word)
  long long c, pitch;
  const void* in;                            // this rank's (n, c) input (reduce-scatter) or (c,)
  void* out;
  unsigned long long* data_in;               // own [2][kNumBuffers][kMaxStripes][ctas], set by up
  unsigned long long* cap_in;                // own [2][ctas], set by down
  unsigned long long* ready_in;              // own [2 seq parity][2: from up, from down][ctas]
  int* err;                                  // own code, rank, step, cta
  float* acc;                                // own [2][pitch] f32 partials
  void* slots;                               // own [2][pitch] words
  unsigned long long* up_cap_in;             // the upstream's arena
  unsigned long long* up_ready_in;
  int* up_err;
  const float* up_acc;
  unsigned long long* down_data_in;          // the downstream's arena
  unsigned long long* down_ready_in;
  int* down_err;
  void* down_slots;
  unsigned long long seq;                    // this call's tag, the same on every rank
  unsigned int sig;                          // 24 bits of the call's kind and shape
};

__device__ __forceinline__ unsigned long long peer_tag(const PeerRing& g, int s) {
  return g.seq * 65536ull + (unsigned long long)(s + 2);      // s >= -1
}

__device__ __forceinline__ unsigned long long ready_tag(const PeerRing& g, int pos) {
  return (g.seq << 32) | ((unsigned long long)(g.sig & 0xffffffu) << 8) |
         (unsigned long long)(pos & 0xff);
}

__device__ __forceinline__ unsigned long long* data_at(unsigned long long* base, int ctas,
                                                       int par, int b, int j, int k) {
  return base + (((long long)par * kNumBuffers + b) * kMaxStripes + j) * ctas + k;
}

__device__ __forceinline__ unsigned long long* cap_at(unsigned long long* base, int ctas,
                                                      int par, int k) {
  return base + (long long)par * ctas + k;
}

__device__ __forceinline__ unsigned long long* ready_at(unsigned long long* base, int ctas,
                                                        int par, int side, int k) {
  return base + ((long long)par * 2 + side) * ctas + k;
}

__device__ __forceinline__ unsigned long long ld_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Thread 0: record a failure in an error word (the first one stays).
__device__ __forceinline__ void put_error(int* err, int code, int rank, int step) {
  if (atomicCAS_system(err, 0, code) == 0) {
    err[1] = rank;
    err[2] = step;
    err[3] = blockIdx.x;
    __threadfence_system();
  }
}

// Thread 0: this rank gives up; its neighbours' waits stop too.
__device__ __forceinline__ void peer_fail(const PeerRing& g, int code, int step) {
  put_error(g.err, code, g.rank, step);
  put_error(g.up_err, code, g.rank, step);
  put_error(g.down_err, code, g.rank, step);
}

// Every thread's stores of this CTA, then the (remote) flag at .sys scope.
__device__ __forceinline__ void peer_signal(unsigned long long* flag, unsigned long long v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    st_release_sys(flag, v);
  }
}

// Thread 0 spins on a flag of this rank's arena until it reads `want`,
// bounded in time; true for the whole CTA if it came.  With `ready`, a tag
// of this call's seq or later that is not `want` is a call-order fault.
__device__ bool peer_wait(const PeerRing& g, const unsigned long long* flag,
                          unsigned long long want, int code, int step, bool ready = false) {
  int ok = 1;
  if (threadIdx.x == 0) {
    const unsigned long long t0 = globaltimer();
    for (;;) {
      const unsigned long long v = ld_acquire_sys(flag);
      if (v == want) break;
      if (ready && (v >> 32) >= (want >> 32)) {
        peer_fail(g, kErrOrder, step);
        ok = 0;
        break;
      }
      if (*(volatile int*)g.err != 0) {          // a neighbour (or another CTA) gave up
        peer_fail(g, *(volatile int*)g.err, step);
        ok = 0;
        break;
      }
      if (globaltimer() - t0 > kSpinTimeoutNs) {
        peer_fail(g, code, step);
        ok = 0;
        break;
      }
    }
    __threadfence();
  }
  return __syncthreads_and(ok);
}

// Post this rank's ready tag to both neighbours, then wait for theirs.
__device__ bool peer_handshake(const PeerRing& g) {
  const int k = blockIdx.x, par = (int)(g.seq & 1);
  if (threadIdx.x == 0) {
    st_release_sys(ready_at(g.down_ready_in, g.ctas, par, 0, k), ready_tag(g, g.my));
    st_release_sys(ready_at(g.up_ready_in, g.ctas, par, 1, k), ready_tag(g, g.my));
  }
  const int n = g.n, d = g.direction;
  return peer_wait(g, ready_at(g.ready_in, g.ctas, par, 0, k), ready_tag(g, wrap(g.my - d, n)),
                   kErrReady, -1, true) &&
         peer_wait(g, ready_at(g.ready_in, g.ctas, par, 1, k), ready_tag(g, wrap(g.my + d, n)),
                   kErrReady, -1, true);
}

// dst[e] = float(src[e]) for e in [a, b), by the whole CTA.
template <typename In>
__device__ __forceinline__ void stage_piece(float* dst, const In* src, long long a, long long b) {
  for (long long e = a + threadIdx.x; e < b; e += blockDim.x) dst[e] = to_float(src[e]);
}

template <typename In, typename Wire>
__global__ void __launch_bounds__(kThreads, 2) ring_rs_peer_kernel(const PeerRing g) {
  const int k = blockIdx.x;
  const int n = g.n, d = g.direction, my = g.my, S = g.stripes;
  const long long c = g.c;
  const long long lo = c * k / g.ctas, hi = c * (k + 1) / g.ctas;
  const int pieces = kNumBuffers * S;
  const In* x = static_cast<const In*>(g.in);
  float* out = static_cast<float*>(g.out);
  if (!peer_handshake(g)) return;
  // step -1: the chunk the downstream adds at its step 0, staged in f32 into
  // parity 1 (step -1's parity) of this rank's partials
  const In* own0 = x + (long long)wrap(my - d, n) * c;
  for (int p = 0; p < pieces; ++p) {
    stage_piece(g.acc + g.pitch, own0, cut(lo, hi, p, pieces), cut(lo, hi, p + 1, pieces));
    peer_signal(data_at(g.down_data_in, g.ctas, 1, p / S, p % S, k), peer_tag(g, -1));
  }
  for (int s = 0; s < n - 1; ++s) {
    const int par = s & 1;
    const bool last = s == n - 2;
    const long long recv = (long long)wrap(my - d * (s + 2), n) * c;
    // the downstream read this parity's partial of step s - 2 at step s - 1
    if (s >= 1 && !last &&
        !peer_wait(g, cap_at(g.cap_in, g.ctas, par, k), peer_tag(g, s - 2), kErrCredit, s))
      return;
    float* dst = last ? out : g.acc + par * g.pitch;
    for (int p = 0; p < pieces; ++p) {
      const long long p0 = cut(lo, hi, p, pieces), p1 = cut(lo, hi, p + 1, pieces);
      if (!peer_wait(g, data_at(g.data_in, g.ctas, par ^ 1, p / S, p % S, k), peer_tag(g, s - 1),
                     kErrData, s))
        return;
      reduce_piece<Wire>(dst, g.up_acc + (par ^ 1) * g.pitch, x + recv, p0, p1);
      if (!last) peer_signal(data_at(g.down_data_in, g.ctas, par, p / S, p % S, k), peer_tag(g, s));
    }
    // the upstream's partial of step s - 1 is read: it may overwrite that
    // parity at step s + 1, where it waits for this credit
    if (s <= n - 4) peer_signal(cap_at(g.up_cap_in, g.ctas, par ^ 1, k), peer_tag(g, s - 1));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ring_ag_peer_kernel(const PeerRing g) {
  const int k = blockIdx.x;
  const int n = g.n, d = g.direction, my = g.my, S = g.stripes;
  const long long c = g.c;
  const long long lo = c * k / g.ctas, hi = c * (k + 1) / g.ctas;
  const T* x = static_cast<const T*>(g.in);
  T* out = static_cast<T*>(g.out);
  const T* slot_me = static_cast<const T*>(g.slots);
  T* slot_dst = static_cast<T*>(g.down_slots);
  if (!peer_handshake(g)) return;
  for (int s = 0; s < n - 1; ++s) {
    const int par = s & 1, nxt = par ^ 1;
    // the downstream drained its slot nxt at step s - 1
    if (s >= 1 &&
        !peer_wait(g, cap_at(g.cap_in, g.ctas, nxt, k), peer_tag(g, s - 1), kErrCredit, s))
      return;
    for (int j = 0; j < S; ++j) {
      const long long p0 = cut(lo, hi, j, S), p1 = cut(lo, hi, j + 1, S);
      if (s == 0) {
        T* const to[2] = {out + my * c, slot_dst + nxt * g.pitch};
        copy_piece(to, x, p0, p1);
      } else {
        T* const to[1] = {slot_dst + nxt * g.pitch};
        copy_piece(to, slot_me + par * g.pitch, p0, p1);
      }
      peer_signal(data_at(g.down_data_in, g.ctas, nxt, 0, j, k), peer_tag(g, s));
    }
    // slot par is sent and was copied out at step s - 1: upstream may write it
    if (s < n - 2) peer_signal(cap_at(g.up_cap_in, g.ctas, par, k), peer_tag(g, s));
    const long long from = (long long)wrap(my - d * (s + 1), n) * c;
    for (int j = 0; j < S; ++j) {
      const long long p0 = cut(lo, hi, j, S), p1 = cut(lo, hi, j + 1, S);
      if (!peer_wait(g, data_at(g.data_in, g.ctas, nxt, 0, j, k), peer_tag(g, s), kErrData, s))
        return;
      T* const to[1] = {out + from};
      copy_piece(to, slot_me + nxt * g.pitch, p0, p1);
    }
    __syncthreads();
  }
}

using PeerFn = void (*)(const PeerRing);

PeerFn pick_peer(int kind, int in_code, int wire_code) {
  if (kind == 0) {
    if (in_code == 0 && wire_code == 0) return ring_rs_peer_kernel<float, float>;
    if (in_code == 0 && wire_code == 1) return ring_rs_peer_kernel<float, __nv_bfloat16>;
    if (in_code == 1 && wire_code == 0) return ring_rs_peer_kernel<__nv_bfloat16, float>;
    if (in_code == 1 && wire_code == 1) return ring_rs_peer_kernel<__nv_bfloat16, __nv_bfloat16>;
  } else if (kind == 1) {
    if (in_code == 4) return ring_ag_peer_kernel<unsigned int>;
    if (in_code == 2) return ring_ag_peer_kernel<unsigned short>;
  }
  return nullptr;
}

using KernelFn = void (*)(const Ring);

// kind 0: reduce-scatter, in_code/wire_code 0 float32, 1 bfloat16;
// kind 1: all-gather, in_code the element size in bytes (2 or 4).
KernelFn pick(int kind, int in_code, int wire_code) {
  if (kind == 0) {
    if (in_code == 0 && wire_code == 0) return ring_rs_kernel<float, float>;
    if (in_code == 0 && wire_code == 1) return ring_rs_kernel<float, __nv_bfloat16>;
    if (in_code == 1 && wire_code == 0) return ring_rs_kernel<__nv_bfloat16, float>;
    if (in_code == 1 && wire_code == 1) return ring_rs_kernel<__nv_bfloat16, __nv_bfloat16>;
  } else if (kind == 1) {
    if (in_code == 4) return ring_ag_kernel<unsigned int>;
    if (in_code == 2) return ring_ag_kernel<unsigned short>;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// CTAs per rank such that a launch over R ranks is resident at once, for every
// instantiation; 0 if none fits.
int ring_ctas(int R) {
  int dev = 0, sms = 0, least = 1 << 30;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int kinds[6][3] = {{0, 0, 0}, {0, 0, 1}, {0, 1, 0}, {0, 1, 1}, {1, 4, 0}, {1, 2, 0}};
  for (const auto& kd : kinds) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pick(kd[0], kd[1], kd[2]), kThreads, 0);
    least = per_sm < least ? per_sm : least;
  }
  return R > 0 ? least * sms / R : 0;
}

int ring_max_ranks() { return kMaxRanks; }

// One cooperative launch of the ring over R ranks.  c elements per chunk;
// pitch: elements from one slot (all-gather, wire type) or partial
// (reduce-scatter, f32) to the next, at least c (the wrapper rounds c up to
// a 16-byte multiple).  pos/dst/src: host arrays
// of R ints; in_ptrs/out_ptrs: host arrays of R device pointers.  flags holds
// the data flags then the credit flags (see Ring).  Zeroes the error word
// first; returns a cudaError_t (0: launched).
int ring_launch(int kind, int in_code, int wire_code, int R, int n, long long c, long long pitch,
                int direction,
                int stripes, int ctas, const int* pos, const int* dst, const int* src,
                const unsigned long long* in_ptrs, const unsigned long long* out_ptrs,
                void* slots, float* acc, unsigned long long* flags, int* err,
                unsigned long long seq, void* stream) {
  KernelFn fn = pick(kind, in_code, wire_code);
  if (fn == nullptr || R < 1 || R > kMaxRanks || n < 2 || stripes < 1 ||
      stripes > kMaxStripes || ctas < 1 || pitch < c)
    return (int)cudaErrorInvalidValue;
  Ring g;
  g.R = R;
  g.n = n;
  g.direction = direction;
  g.stripes = stripes;
  g.ctas = ctas;
  g.c = c;
  g.pitch = pitch;
  for (int i = 0; i < R; ++i) {
    g.pos[i] = pos[i];
    g.dst[i] = dst[i];
    g.src[i] = src[i];
    g.in[i] = reinterpret_cast<const void*>(in_ptrs[i]);
    g.out[i] = reinterpret_cast<void*>(out_ptrs[i]);
  }
  g.slots = slots;
  g.acc = acc;
  g.data_flags = flags;
  g.cap_flags = flags + (long long)R * 2 * kNumBuffers * kMaxStripes * ctas;
  g.err = err;
  g.seq = seq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(err, 0, 4 * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&g};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fn), dim3(ctas, R), dim3(kThreads),
                                  args, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// CTAs per rank of the per-rank route such that R ranks' launches on one
// device are resident at once (under MPS, or on separate cards a fortiori);
// 0 if none fits.
int ring_peer_ctas(int R) {
  int dev = 0, sms = 0, least = 1 << 30;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int kinds[6][3] = {{0, 0, 0}, {0, 0, 1}, {0, 1, 0}, {0, 1, 1}, {1, 4, 0}, {1, 2, 0}};
  for (const auto& kd : kinds) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pick_peer(kd[0], kd[1], kd[2]),
                                                  kThreads, 0);
    least = per_sm < least ? per_sm : least;
  }
  return R > 0 ? least * sms / R : 0;
}

// This rank's part of a ring, one cooperative launch of grid (ctas).  own,
// up, down: base addresses of this rank's arena and its neighbours' (peer
// mappings), all of one layout; offs: byte offsets of the data flags, the
// credit flags, the ready tags, the error word, the f32 partials and the
// slots in it.  rank: this rank's global rank (for the error word); my: its
// position in its ring of n.  Zeroes this
// rank's error word first; returns a cudaError_t (0: launched).
int ring_peer_launch(int kind, int in_code, int wire_code, int n, int my, long long c,
                     long long pitch, int direction, int stripes, int ctas, const void* in,
                     void* out, void* own, void* up, void* down, const long long* offs,
                     int rank, unsigned long long seq, unsigned int sig, void* stream) {
  PeerFn fn = pick_peer(kind, in_code, wire_code);
  if (fn == nullptr || n < 2 || my < 0 || my >= n || stripes < 1 || stripes > kMaxStripes ||
      ctas < 1 || pitch < c)
    return (int)cudaErrorInvalidValue;
  char* a = static_cast<char*>(own);
  char* u = static_cast<char*>(up);
  char* w = static_cast<char*>(down);
  PeerRing g;
  g.n = n;
  g.direction = direction;
  g.stripes = stripes;
  g.ctas = ctas;
  g.my = my;
  g.rank = rank;
  g.c = c;
  g.pitch = pitch;
  g.in = in;
  g.out = out;
  g.data_in = reinterpret_cast<unsigned long long*>(a + offs[0]);
  g.cap_in = reinterpret_cast<unsigned long long*>(a + offs[1]);
  g.ready_in = reinterpret_cast<unsigned long long*>(a + offs[2]);
  g.err = reinterpret_cast<int*>(a + offs[3]);
  g.acc = reinterpret_cast<float*>(a + offs[4]);
  g.slots = a + offs[5];
  g.up_cap_in = reinterpret_cast<unsigned long long*>(u + offs[1]);
  g.up_ready_in = reinterpret_cast<unsigned long long*>(u + offs[2]);
  g.up_err = reinterpret_cast<int*>(u + offs[3]);
  g.up_acc = reinterpret_cast<const float*>(u + offs[4]);
  g.down_data_in = reinterpret_cast<unsigned long long*>(w + offs[0]);
  g.down_ready_in = reinterpret_cast<unsigned long long*>(w + offs[2]);
  g.down_err = reinterpret_cast<int*>(w + offs[3]);
  g.down_slots = w + offs[5];
  g.seq = seq;
  g.sig = sig;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(g.err, 0, 4 * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&g};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fn), dim3(ctas), dim3(kThreads), args,
                                  0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The arena of the per-rank route: device memory of its own (never the
// caching allocator's: an IPC handle names a whole cudaMalloc allocation,
// and expandable segments cannot be exported this way), zeroed.
int peer_alloc(long long bytes, unsigned long long* out) {
  void* p = nullptr;
  cudaError_t e = cudaMalloc(&p, bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemset(p, 0, bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e != cudaSuccess) {
    cudaFree(p);
    return (int)e;
  }
  *out = reinterpret_cast<unsigned long long>(p);
  return 0;
}

int peer_free(unsigned long long p) { return (int)cudaFree(reinterpret_cast<void*>(p)); }

int peer_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

int peer_export(unsigned long long p, unsigned char* handle) {
  cudaIpcMemHandle_t h;
  cudaError_t e = cudaIpcGetMemHandle(&h, reinterpret_cast<void*>(p));
  if (e != cudaSuccess) {
    cudaGetLastError();                     // not sticky: clear it
    return (int)e;
  }
  memcpy(handle, &h, sizeof(h));
  return 0;
}

int peer_open(const unsigned char* handle, unsigned long long* out) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  void* p = nullptr;
  cudaError_t e = cudaIpcOpenMemHandle(&p, h, cudaIpcMemLazyEnablePeerAccess);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  *out = reinterpret_cast<unsigned long long>(p);
  return 0;
}

int peer_close(unsigned long long p) {
  return (int)cudaIpcCloseMemHandle(reinterpret_cast<void*>(p));
}

const char* ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
