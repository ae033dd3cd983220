// Fused ring reduce-scatter and all-gather for Hopper (sm_90a), with a plain C
// interface that kernels/ring_dma.py loads through ctypes.
//
// Replace src/repro/kernels/ring_dma.py::_rs_dma_kernel and ::_ag_dma_kernel,
// the Pallas TPU kernels of the backend="pallas" cross-island rings.  Same
// functions and the same protocol: each ring step's payload is split into
// kNumBuffers streams and n_stripes stripes, each with its own receive slot
// per step parity and its own ready flag; a receiver credits its upstream
// sender once it has drained a slot, and a sender takes that credit before
// it reuses the slot two steps later.  Credits are only issued where a
// matching wait exists.  The reduce-scatter keeps an f32 accumulator and puts
// the running partial on the wire in the wire dtype, rounded to nearest even
// at every step, exactly where the reference's emulated schedule casts, so
// the sums come out bit for bit as there.
//
// One launch covers every rank of the mesh that shares this device: grid
// (ctas, R).  CTA k of rank r owns the contiguous column slice k of every
// chunk and runs the whole ring protocol for that slice with CTA k of its
// neighbours, so CTAs of one rank never wait for each other.  A "wire hop"
// is a store of the sender straight into the receiver's slot in device
// memory (the counterpart of the remote copy), then a fence and a release
// store of the slot's flag; the receiver spins on the flag with acquire
// loads and reads the slot around L1.  Because CTAs wait for CTAs of other
// ranks, every CTA of the launch must be resident at once: the launch is
// cooperative and fails if the grid does not fit.  Every wait gives up
// after kSpinTimeoutNs of %globaltimer, writes the error word and returns,
// and every other wait then stops too: a protocol fault becomes an error
// that the wrapper raises, not a hung card.  Flags carry a per-call tag
// (seq, step), so the buffers are reused across calls without a memset.
//
// What bounds it on an H100: no arithmetic to speak of, so device memory.
// Per rank and step the reduce-scatter reads a chunk slice of the input,
// the partial and the slot and writes the remote slot and the partial;
// one card's "wire" is HBM, so these kernels time the protocol plus HBM
// traffic, not a link.  The reduce-scatter's copies are scalar, coalesced
// element loops.  The all-gather's are 16-byte vectors, four in flight per
// thread (loads with an L2 256-byte prefetch hint, streaming stores), with a
// scalar head and tail where a piece's bounds fall inside a
// vector; a destination whose alignment mod 16 differs from the source's
// takes the loaded vectors as scalar stores.  Its step 0 reads the input
// once and writes both the own output row and the downstream slot, so no
// staging copy into the own slot is made: at n = 2 a rank reads 2c and
// writes 3c elements.  Slots lie `pitch` elements apart, c rounded up to a
// whole number of 16-byte vectors, so every slot starts 16-byte aligned.
// No TMA, cp.async.bulk or multimem stores yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNumBuffers = 2;    // ring_dma.NUM_BUFFERS
constexpr int kMaxStripes = 8;    // transport.stripe.MAX_STRIPES
constexpr int kMaxRanks = 64;
constexpr int kThreads = 512;
constexpr unsigned long long kSpinTimeoutNs = 2000000000ull;
constexpr int kErrData = 1;       // a slot's ready flag never came
constexpr int kErrCredit = 2;     // a credit never came

struct Ring {
  int R, n, direction, stripes, ctas;
  long long c;                         // elements per chunk
  long long pitch;                     // elements from one slot to the next (>= c, 16-byte multiple)
  int pos[kMaxRanks];                  // position of each rank in its ring
  int dst[kMaxRanks];                  // downstream neighbour (global rank)
  int src[kMaxRanks];                  // upstream neighbour
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
  void* slots;                         // [R][2][pitch] in the wire type
  float* acc;                          // [R][2][c] partials (reduce-scatter)
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

template <typename In, typename Wire>
__global__ void __launch_bounds__(kThreads) ring_rs_kernel(const Ring g) {
  const int r = blockIdx.y, k = blockIdx.x;
  const int n = g.n, d = g.direction, my = g.pos[r], S = g.stripes;
  const long long c = g.c;
  const long long lo = c * k / g.ctas, hi = c * (k + 1) / g.ctas;
  const int pieces = kNumBuffers * S;
  const In* x = static_cast<const In*>(g.in[r]);
  float* out = static_cast<float*>(g.out[r]);
  float* acc = g.acc + (long long)r * 2 * c;
  const Wire* slot_me = static_cast<const Wire*>(g.slots) + (long long)r * 2 * g.pitch;
  Wire* slot_dst = static_cast<Wire*>(g.slots) + (long long)g.dst[r] * 2 * g.pitch;

  for (int s = 0; s < n - 1; ++s) {
    const int par = s & 1;
    const long long send = (long long)wrap(my - d * (s + 1), n) * c;
    const long long recv = (long long)wrap(my - d * (s + 2), n) * c;
    // the downstream rank drained this parity's slot at step s - 2
    if (s >= 2 && !cta_wait(g, cap_flag(g, r, par, k), tag(g, s - 2), kErrCredit, r, s)) return;
    // every stripe of every stream goes out before any wait
    for (int p = 0; p < pieces; ++p) {
      const long long p1 = cut(lo, hi, p + 1, pieces);
      for (long long e = cut(lo, hi, p, pieces) + threadIdx.x; e < p1; e += blockDim.x) {
        const float v = s == 0 ? to_float(x[send + e]) : acc[((s - 1) & 1) * c + e];
        slot_dst[par * g.pitch + e] = to_wire<Wire>(v);
      }
      cta_signal(data_flag(g, g.dst[r], par, p / S, p % S, k), tag(g, s));
    }
    // stream 0 reduces while stream 1 may still be arriving
    for (int p = 0; p < pieces; ++p) {
      if (!cta_wait(g, data_flag(g, r, par, p / S, p % S, k), tag(g, s), kErrData, r, s)) return;
      const long long p1 = cut(lo, hi, p + 1, pieces);
      for (long long e = cut(lo, hi, p, pieces) + threadIdx.x; e < p1; e += blockDim.x) {
        const float v = to_float(x[recv + e]) + to_float(__ldcg(slot_me + par * g.pitch + e));
        if (s == n - 2)
          out[e] = v;
        else
          acc[par * c + e] = v;
      }
    }
    // this parity's slot is drained: upstream may reuse it at step s + 2
    if (s + 2 <= n - 2) cta_signal(cap_flag(g, g.src[r], par, k), tag(g, s));
  }
}

constexpr int kUnroll = 4;        // 16-byte vectors in flight per thread

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
// pitch: elements from one slot to the next, at least c (the wrapper rounds
// c up to a 16-byte multiple).  pos/dst/src: host arrays
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

const char* ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
