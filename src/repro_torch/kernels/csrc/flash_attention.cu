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
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s):
//  * smollm's prefill (B 8, Hq 9, Hkv 3, S 512, d 64, causal) and Mixtral's
//    (B 8, Hq 32, Hkv 8, S 512, d 128): bytes (12.6 and 84 MB of q, k, v and
//    o against 2.4 and 22 GFLOP of valid pairs).  Blocks hold 1 to 4 key
//    tiles each, so the fixed cost of a work item (its q load, the ring's
//    fill, its store) weighs more than either bound.
//  * zamba2's shared attention (B 8, Hq 32, S 2048, d 112, causal) and
//    Mixtral's window (1 x 4608, d 128, window 4096): operations, 241 and
//    172 GFLOP of valid pairs.  Here the tensor cores' rate is the whole game.
// The design keeps every intermediate on chip (a work item, one 128-row q
// tile of one head, reads its q tile once, streams k/v tiles, writes o once;
// scores and probabilities never leave registers) and feeds the tensor cores
// the Hopper way:
//  * A producer warpgroup (one thread of it) issues TMA copies
//    (cp.async.bulk.tensor over one 4-D tensor map per operand, the strided
//    (B, H, S, d) view as it is): q into two buffers, k and v into a ring (2
//    stages at d 112 and 128, 3 at d 32 and 64) with full and empty
//    mbarriers, so the next tiles, and the next item's q, are in flight
//    while the consumers compute.  Tiles the mask empties (above the
//    diagonal, before the window, past k_len) are never loaded.
//  * Two consumer warpgroups of 64 query rows each run wgmma: S = Q K^T with
//    both operands in 128-byte-swizzled shared memory, then O += P V with P
//    from registers (the S accumulator rounded to bf16) and V as the
//    MN-major operand.  Accumulators are f32.
//    The warpgroups take turns (two named barriers) to issue Q K^T, so one's
//    softmax runs while the other's products are on the tensor cores.
//  * The softmax works in log2 units: on a tile inside the mask for every
//    row of the warpgroup the scale folds into the exponent (one FMA and an
//    ex2 per score); the per-element mask runs only on tiles that meet the
//    diagonal, the window's edge or k_len.
//  * d 112 is padded to 128 in shared memory only: two 64-column boxes over
//    a tensor map whose d extent is 112, so columns 112-127 arrive as zeros
//    and Q K^T runs over 128 (P V over 112); d 32 pads to 64 the same way,
//    and d 100 (llama-3b) to 128 (P V over 104, the next multiple of 8).
//    TMA takes global strides of 16 bytes only, and d 100 in the model's
//    layout has a head stride of 200 bytes: the wrapper gives this route
//    q, k, v and o in rows padded to 104 elements (kernels/flash_attention.py,
//    tma_ready; the copy's cost is in PERF.md), and the maps' d extent of
//    100 still fills columns 100-127 with zeros.
//  * O is normalised in registers, staged in the item's q buffer and written
//    by a TMA store, which drops rows past Sq and columns past d.
//  * Persistent blocks, one per SM, take the work items in order, heaviest
//    causal q tile first within a group of 8 heads (whose k/v stay in L2):
//    the first wave by blockIdx.x, the rest from a counter in device memory,
//    so a block that finishes early takes more and the heaviest items do
//    not form the tail.
// -Xptxas -v reports 168 registers and no spills of the consumers: S, O and
// P (64 + 64 + 32) fit in the 168 that ptxas gave both roles.  FlashAttention
// 3's overlap of one tile's softmax with the previous tile's P V keeps two P
// tiles live; ptxas serialised its wgmma for lack of registers, and it ran
// slower, so this kernel does not overlap within a warpgroup.  wgmma and not
// mma.sync: only wgmma reaches Hopper's tensor-core rate.
//
// Two routes by input type:
//  * bf16: the design above.  The scores are scaled in f32 after the product,
//    where the reference scales q in f32 before it; the probabilities are
//    rounded to bf16 for the P.V product, where the reference multiplies f32
//    by f32.  Both differences sit far inside the bf16 output's own rounding.
//  * f32: plain FMA on the CUDA cores, all in f32 like the reference (bf16
//    tensor cores would lose the f32 inputs' precision).  Not on a hot path.
// Statistics (m, l) and the output accumulator are f32 on both routes; the
// output is cast to the input type.  Ragged Sq and Sk are handled by masked
// loads (zero rows: TMA's out-of-bounds fill on the bf16 route) and masked
// stores, not by padding in device memory.
//
// The row logsumexp for the backward (csrc/flash_attention_bwd.cu): given a
// non-null `lse` (B, Hq, Sq) f32 buffer, each valid query row also writes
// m + log(max(l, 1e-30)) in natural-log units, the logsumexp of its scaled,
// masked scores (m the running maximum, l the running sum of exp(s - m); the
// bf16 route converts its log2-unit maximum with ln 2).  With a null pointer
// the kernel does exactly what it does without this output.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

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
  // bf16 route: two ints, 0 at launch: the items taken past the first wave,
  // and the blocks done taking; the last block done sets both back to 0
  int* sched;
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
// bf16 route: TMA, wgmma, a producer warpgroup and two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;          // query rows per block: 2 consumer warpgroups x 64
constexpr int kBK = 128;          // keys per k/v tile
constexpr int kConsumers = 256;   // threads of the two consumer warpgroups
// and a producer warpgroup, of which one thread issues every copy.  A whole
// warpgroup, not one warp: the block's register pool is fixed at launch
// (ptxas sizes it at 168 a thread for 3 warpgroups), setmaxnreg only moves
// registers within it, and setmaxnreg.inc waits until enough are free.  With
// one producer warp (288 threads) the consumers' inc to 240 waited forever;
// with a warpgroup at 40, 128 x 40 + 256 x 232 = 384 x 168.
constexpr int kThreads = kConsumers + 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kTurnBar = 1;       // named barriers kTurnBar, kTurnBar + 1
constexpr int kStoreBar = 3;      // and kStoreBar + warpgroup for the epilogue
constexpr int kHeadGroup = 8;     // heads whose items are taken together
// An mbarrier wait that lasts this long (about 2 s) is a protocol fault: the
// kernel traps, so the launch fails instead of hanging the card.
constexpr long long kWaitCycles = 1ll << 32;
constexpr int kBox = 64;          // columns per TMA box: one 128-byte swizzle row
constexpr int kRowBytes = 128;    // bytes of a box row in shared memory
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Head dim as the tensor cores see it: d 32 and 64 in one 64-column box,
// d 112 and 128 in two.  Columns from d up to the padded width arrive as zeros
// (TMA's out-of-bounds fill over a tensor map whose d extent is d).
template <int D>
struct Hopper {
  static constexpr int DP = D <= 64 ? 64 : 128;
  // the P V product's width: d rounded up to wgmma's n step of 8 (112, 104)
  static constexpr int ON = D > 64 ? (D + 7) / 8 * 8 : DP;
  static constexpr int kBoxes = DP / kBox;
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kKBytes = kBK * DP * 2;          // one k (or v) tile
  static constexpr int kStageBytes = 2 * kKBytes;       // k tile, then v tile
  // two q buffers, so the next item's q arrives while this one computes;
  // the ring as deep as the rest of 227 KB allows: 3 stages at DP 64 (128
  // KB in all), 2 at DP 128 (193 KB)
  static constexpr int kQBufs = 2;
  static constexpr int kStages = DP == 64 ? 3 : 2;
  // 1024-byte alignment slack, the q buffers, the ring, the mbarriers, the
  // item slots
  static constexpr int SMEM =
      1024 + kQBufs * kQBytes + kStages * kStageBytes + 16 * (kQBufs + kStages) + 16;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
__device__ __forceinline__ int ld_shared(uint32_t addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// One box of the 4-D (d, S, H, B) tensor map into shared memory; completion
// is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head), "r"(batch),
      "r"(bar)
      : "memory");
}

// One box from shared memory into the 4-D tensor map; the bulk group
// tracks completion.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col, int row,
                                          int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row), "r"(head), "r"(batch)
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

// Named barriers 1 and 2 pass the turn to issue wgmma between the consumer
// warpgroups: warpgroup w syncs on kTurnBar + w, the other arrives there.
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (m64 x n128, f32) = (scale_d ? d : 0) + a (smem) * b (smem); both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d (m64 x n128, f32) += a (registers, bf16 fragments) * b (smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (m64 x n112, f32) += a (registers, bf16 fragments) * b (smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n112(float (&d)[56], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (m64 x n104, f32) += a (registers, bf16 fragments) * b (smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n104(float (&d)[52], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51"
      "}, {%52, %53, %54, %55}, %56, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (m64 x n64, f32) += a (registers, bf16 fragments) * b (smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<104>(float (&o)[52], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n104(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<112>(float (&o)[56], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n112(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

// S = Q K^T for one warpgroup: m64 x n128 (kBK) over DP / 16 k-steps of 16 columns
// (32 bytes) inside each 64-column box.  Both operands K-major, 8-row groups
// 1024 bytes apart; q_wg is the warpgroup's 64 rows of the q tile.
template <int DP>
__device__ __forceinline__ void issue_qk(float (&sc)[kBK / 2], uint32_t q_wg, uint32_t k_tile) {
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = smem_desc(q_wg + (kk / 4) * kBQ * kRowBytes + col, 16, 1024);
    const uint64_t db = smem_desc(k_tile + (kk / 4) * kBK * kRowBytes + col, 16, 1024);
    wgmma_ss_n128(sc, da, db, kk > 0);
  }
}

// O += P V: P in registers as the A fragments of m64nONk16, V the MN-major B
// operand (d contiguous): 8-key groups 1024 bytes apart, its two 64-column
// boxes kBK x 128 bytes apart.
template <int ON>
__device__ __forceinline__ void issue_pv(float (&o)[ON / 2], const uint32_t (&pf)[kBK / 16][4],
                                         uint32_t v_tile) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_pv<ON>(o, pf[kk], smem_desc(v_tile + kk * 16 * kRowBytes, kBK * kRowBytes, 1024));
}

// Online softmax of one tile's scores (keys k0 .. k0 + kBK) for this thread's
// rows r0 and r0 + 8, in log2 units: sc becomes P, m_r and l_r are updated
// and corr is the factor for O.  A tile inside the mask for every row of the
// warpgroup (rows rw0 .. rw0 + 63) folds the scale into the exponent (one
// FMA); a tile that meets the diagonal, the window's edge or k_len masks
// each element.  A row's 128 scores lie across the 4 threads of a quad.
__device__ __forceinline__ void softmax_tile(const Params& p, float (&sc)[kBK / 2],
                                             float (&m_r)[2], float (&l_r)[2], float (&corr)[2],
                                             int rw0, int r0, int k0, int lane, float sl2) {
  const bool interior = k0 + kBK <= p.k_len && (!p.causal || k0 + kBK - 1 <= rw0) &&
                        (p.window == 0 || rw0 + 63 - k0 < p.window);
  float mx[2] = {kNegInf, kNegInf};
  if (interior) {
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    mx[0] *= sl2;
    mx[1] *= sl2;
  } else {
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) {
      const int r = r0 + ((e >> 1) & 1) * 8;
      const int c = k0 + (e >> 2) * 8 + 2 * (lane & 3) + (e & 1);
      sc[e] = key_valid(p, r, c) ? sc[e] * sl2 : kNegInf;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_r[i], mx[i]);
    corr[i] = fast_exp2(m_r[i] - m_new);
    m_r[i] = m_new;
    l_r[i] *= corr[i];
  }
  if (interior) {
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) {
      sc[e] = fast_exp2(fmaf(sc[e], sl2, -m_r[(e >> 1) & 1]));
      l_r[(e >> 1) & 1] += sc[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) {
      sc[e] = fast_exp2(sc[e] - m_r[(e >> 1) & 1]);
      l_r[(e >> 1) & 1] += sc[e];
    }
  }
}

// P (f32, the S accumulator's layout) rounded to bf16 as the A fragments of
// the P V product: the accumulator of m64n128 already is that layout.
__device__ __forceinline__ void pack_p(uint32_t (&pf)[kBK / 16][4], const float (&sc)[kBK / 2]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    pf[kk][0] = pack_f32(sc[8 * kk + 0], sc[8 * kk + 1]);
    pf[kk][1] = pack_f32(sc[8 * kk + 2], sc[8 * kk + 3]);
    pf[kk][2] = pack_f32(sc[8 * kk + 4], sc[8 * kk + 5]);
    pf[kk][3] = pack_f32(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// Work items are (q tile, q head, batch).  Consecutive items take the heads
// of one group of kHeadGroup, heaviest causal q tile first; so the blocks in
// flight at one time share the k/v of a few heads in L2, and each block
// meets every weight of tile in turn.
__device__ __forceinline__ void decode_item(int item, int n_qt, int n_heads, int& q_tile,
                                            int& head) {
  const int per_group = n_qt * kHeadGroup;
  const int g = item / per_group;
  const int rem = item - g * per_group;
  const int hg = min(kHeadGroup, n_heads - g * kHeadGroup);
  q_tile = n_qt - 1 - rem / hg;
  head = g * kHeadGroup + rem % hg;
}

// Persistent: one block per SM takes the items in order, the first wave by
// blockIdx.x and then each next one from a counter in device memory (a slot
// of sched_slots), so a block that finishes early takes more.  Shared memory (1024-byte aligned
// for the 128-byte swizzle): kQBufs q buffers, each kBoxes boxes of kBQ rows
// x 128 bytes; the ring of kStages stages, each the k tile then the v tile
// as kBoxes boxes of kBK rows x 128 bytes; then the mbarriers
// q_full[kQBufs], q_empty[kQBufs], full[kStages], empty[kStages]; then the
// item of each q buffer (-1: no more).  A q buffer also stages the item's O
// for its TMA store.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o, const Params p) {
  using T = Hopper<D>;
  constexpr int DP = T::DP;
  constexpr int ON = T::ON;
  constexpr int QB = T::kQBufs;
  constexpr int ST = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = q_base + QB * T::kQBytes;
  const uint32_t q_full = ring + ST * T::kStageBytes;
  const uint32_t q_empty = q_full + 8 * QB;
  const uint32_t full_bar = q_empty + 8 * QB;
  const uint32_t empty_bar = full_bar + 8 * ST;
  const uint32_t item_slot = empty_bar + 8 * ST;

  const int n_qt = (p.Sq + kBQ - 1) / kBQ;
  const int n_heads = p.Hq * p.B;
  const int n_items = n_qt * n_heads;

  if (threadIdx.x == 0) {
    for (int i = 0; i < QB; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, 2);  // the storing thread of each warpgroup
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer warpgroup: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      int tile = 0;  // k/v tiles issued so far: the ring's position
      for (int j = 0;; ++j) {  // j: items taken so far by this block
        const int item = j == 0 ? blockIdx.x : gridDim.x + atomicAdd(p.sched, 1);
        const int qb = j % QB;
        // the buffer's previous item has been stored (passes at once at first)
        mbar_wait(q_empty + 8 * qb, ((j / QB) & 1) ^ 1);
        st_shared(item_slot + 4 * qb, item < n_items ? item : -1);
        if (item >= n_items) {
          mbar_arrive(q_full + 8 * qb);
          // every block has taken its last item: leave the counter at 0
          if (atomicAdd(p.sched + 1, 1) == static_cast<int>(gridDim.x) - 1) {
            p.sched[0] = 0;
            p.sched[1] = 0;
          }
          break;
        }
        int q_tile, head;
        decode_item(item, n_qt, n_heads, q_tile, head);
        const int q0 = q_tile * kBQ, h = head % p.Hq, b = head / p.Hq;
        const int hk = h / (p.Hq / p.Hkv);
        int t0, t1;
        key_tile_range(p, q0, kBQ, kBK, t0, t1);
        // at least one tile: a block none of whose rows has a valid key (k_len
        // or a window) computes over one masked tile, whose output is not defined
        const int n_tiles = max(t1 - t0, 1);
        mbar_expect_tx(q_full + 8 * qb, T::kQBytes);
        const uint32_t q_s = q_base + qb * T::kQBytes;
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load(q_s + x * kBQ * kRowBytes, &tm_q, q_full + 8 * qb, x * kBox, q0, h, b);
        for (int it = 0; it < n_tiles; ++it, ++tile) {
          const int s = tile % ST;
          // the consumers released this stage's previous tile (passes at once
          // on the first round)
          mbar_wait(empty_bar + 8 * s, ((tile / ST) & 1) ^ 1);
          mbar_expect_tx(full_bar + 8 * s, T::kStageBytes);
          const uint32_t k_dst = ring + s * T::kStageBytes;
          const uint32_t v_dst = k_dst + T::kKBytes;
          const int k0 = (t0 + it) * kBK;
#pragma unroll
          for (int x = 0; x < T::kBoxes; ++x) {
            tma_load(k_dst + x * kBK * kRowBytes, &tm_k, full_bar + 8 * s, x * kBox, k0, hk, b);
            tma_load(v_dst + x * kBK * kRowBytes, &tm_v, full_bar + 8 * s, x * kBox, k0, hk, b);
          }
        }
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows each.  Per key tile, in this
    // warpgroup's turn, issue S = Q K^T and pass the turn; then the softmax,
    // O += P V and the release of the stage.  The other warpgroup's products
    // run on the tensor cores while this one's softmax runs.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const float sl2 = p.scale * kLog2e;  // scores in log2 units
    float o[ON / 2];
    float sc[kBK / 2];         // S, then P in f32
    uint32_t pf[kBK / 16][4];  // P in bf16 A fragments

    // The first turn is warpgroup 0's.
    if (wg == 1) named_bar_arrive(kTurnBar, kConsumers);
    int tile = 0;
    for (int j = 0;; ++j) {
      const int qb = j % QB;
      mbar_wait(q_full + 8 * qb, (j / QB) & 1);
      const int item = ld_shared(item_slot + 4 * qb);
      if (item < 0) break;
      int q_tile, head;
      decode_item(item, n_qt, n_heads, q_tile, head);
      const int q0 = q_tile * kBQ, h = head % p.Hq, b = head / p.Hq;
      int t0, t1;
      key_tile_range(p, q0, kBQ, kBK, t0, t1);
      const int n_tiles = max(t1 - t0, 1);
      const int rw0 = q0 + wg * 64;               // this warpgroup's first row
      const int r0 = rw0 + warp * 16 + lane / 4;  // rows r0 (i = 0) and r0 + 8 (i = 1)
      const uint32_t q_wg = q_base + qb * T::kQBytes + wg * 64 * kRowBytes;

#pragma unroll
      for (int e = 0; e < ON / 2; ++e) o[e] = 0.f;
      float m_r[2] = {kNegInf, kNegInf};  // running max, log2 units
      float l_r[2] = {0.f, 0.f};          // this thread's share of the row sums
      float corr[2];
      for (int it = 0; it < n_tiles; ++it, ++tile) {
        const int s = tile % ST;
        mbar_wait(full_bar + 8 * s, (tile / ST) & 1);
        named_bar_sync(kTurnBar + wg, kConsumers);
        const uint32_t k_tile = ring + s * T::kStageBytes;
        issue_qk<DP>(sc, q_wg, k_tile);
        wgmma_commit();
        named_bar_arrive(kTurnBar + (wg ^ 1), kConsumers);
        wgmma_wait<0>();
        fence_regs(sc);
        softmax_tile(p, sc, m_r, l_r, corr, rw0, r0, (t0 + it) * kBK, lane, sl2);
        fence_regs(o);
#pragma unroll
        for (int e = 0; e < ON / 2; ++e) o[e] *= corr[(e >> 1) & 1];
        pack_p(pf, sc);
        issue_pv<ON>(o, pf, k_tile + T::kKBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty_bar + 8 * s);
      }

      // Normalise; write the row logsumexp; O goes to shared memory over
      // this warpgroup's own q rows (its last Q K^T has completed) in the
      // swizzled layout of the o tensor map, and one thread stores it with
      // TMA, which drops rows past Sq and columns past d.
      float l_tot[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float l = l_r[i];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        l_tot[i] = fmaxf(l, 1e-30f);
        const int r = r0 + 8 * i;
        // the natural-log logsumexp of the scaled, masked scores
        if (p.lse != nullptr && (lane & 3) == 0 && r < p.Sq)
          p.lse[((long long)b * p.Hq + h) * p.Sq + r] = m_r[i] * kLn2 + logf(l_tot[i]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float inv = 1.f / l_tot[i];
        const int lr = warp * 16 + lane / 4 + 8 * i;  // row within the warpgroup
#pragma unroll
        for (int n = 0; n < ON / 8; ++n) {
          const uint32_t addr = q_wg + (n / 8) * kBQ * kRowBytes + lr * kRowBytes +
                                (((n % 8) ^ (lr % 8)) * 16) + (lane & 3) * 4;
          st_shared(addr, pack_f32(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv));
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_bar_sync(kStoreBar + wg, 128);
      if (threadIdx.x % 128 == 0) {
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x)
          tma_store(&tm_o, q_wg + x * kBQ * kRowBytes, x * kBox, rw0, h, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(q_empty + 8 * qb);
      }
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

// The 4-D map (d, S, H, B) of a bf16 (B, H, S, d) view with element strides
// sb, sh, ss (d dense): boxes of 64 columns x `rows` rows, 128-byte swizzle.
// The d extent is d itself, so a box's columns past d arrive as zeros.
int encode_map(CUtensorMap* map, const void* ptr, int d, int S, int H, int B, long long ss,
               long long sh, long long sb, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encoder();
  if (encode == nullptr) return kMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)(S > 0 ? S : 1), (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + static_cast<int>(r);
}

// The scheduler's counters: per device kSchedSlots pairs of ints, zeroed
// once; each launch takes the next slot, and its last block sets the pair
// back to 0.  Launches that overlap in time (on other streams or threads)
// take other slots unless kSchedSlots launches lie between them.
constexpr int kSchedSlots = 4096;
constexpr int kMaxDevices = 64;

struct DeviceInfo {
  int sms = 0;
  int* slots = nullptr;
};

int device_info(cudaStream_t stream, DeviceInfo*& info) {
  static DeviceInfo infos[kMaxDevices];
  static std::mutex lock;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(lock);
  DeviceInfo& d = infos[dev];
  if (d.slots == nullptr) {
    e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    int* slots = nullptr;
    if (e == cudaSuccess) e = cudaMalloc(&slots, 2 * kSchedSlots * sizeof(int));
    if (e == cudaSuccess) e = cudaMemsetAsync(slots, 0, 2 * kSchedSlots * sizeof(int), stream);
    if (e != cudaSuccess) return e;
    d.slots = slots;
  }
  info = &d;
  return cudaSuccess;
}

std::atomic<unsigned> next_slot{0};  // shared by every head dim's launches

template <int D>
int launch_bf16(Params p, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  int err = encode_map(&tm_q, p.q, D, p.Sq, p.Hq, p.B, p.q_ss, p.q_sh, p.q_sb, kBQ);
  if (!err) err = encode_map(&tm_k, p.k, D, p.Sk, p.Hkv, p.B, p.k_ss, p.k_sh, p.k_sb, kBK);
  if (!err) err = encode_map(&tm_v, p.v, D, p.Sk, p.Hkv, p.B, p.v_ss, p.v_sh, p.v_sb, kBK);
  if (!err) err = encode_map(&tm_o, p.o, D, p.Sq, p.Hq, p.B, p.o_ss, p.o_sh, p.o_sb, 64);
  if (err) return err;
  const int smem = Hopper<D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  DeviceInfo* info = nullptr;
  err = device_info(stream, info);
  if (err) return err;
  p.sched = info->slots + 2 * (next_slot++ % kSchedSlots);
  const long long items = (long long)((p.Sq + kBQ - 1) / kBQ) * p.Hq * p.B;
  const dim3 grid(static_cast<unsigned>(items < info->sms ? items : info->sms));
  flash_fwd_bf16<D><<<grid, kThreads, smem, stream>>>(tm_q, tm_k, tm_v, tm_o, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  d: 32, 64, 100, 112 or 128.  lse: (B, Hq, Sq) f32
// or null.  Returns 0 on success, else the CUDA error code of the launch, or
// 100000 + the CUresult of a tensor map the bf16 route could not encode; the
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
                 o_sb, o_sh, o_ss, causal, window, k_len, scale, nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (d) {
      case 32: return launch_bf16<32>(p, st);
      case 64: return launch_bf16<64>(p, st);
      case 100: return launch_bf16<100>(p, st);
      case 112: return launch_bf16<112>(p, st);
      case 128: return launch_bf16<128>(p, st);
    }
  } else if (dtype == 0) {
    const dim3 grid((Sq + kSimtBQ - 1) / kSimtBQ, Hq, B);
    switch (d) {
      case 32: return launch(flash_fwd_f32<32>, grid, kSimtThreads, SimtTile<32>::SMEM, st, p);
      case 64: return launch(flash_fwd_f32<64>, grid, kSimtThreads, SimtTile<64>::SMEM, st, p);
      case 100: return launch(flash_fwd_f32<100>, grid, kSimtThreads, SimtTile<100>::SMEM, st, p);
      case 112: return launch(flash_fwd_f32<112>, grid, kSimtThreads, SimtTile<112>::SMEM, st, p);
      case 128: return launch(flash_fwd_f32<128>, grid, kSimtThreads, SimtTile<128>::SMEM, st, p);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int err) {
  if (err >= kMapError) return "cuTensorMapEncodeTiled failed (CUresult = code - 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
