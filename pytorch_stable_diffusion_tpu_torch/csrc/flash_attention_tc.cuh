// The bf16 tensor-core flash attention of K1 (flash_attention_bsc.cu), K4
// (flash_attention_streamed.cu) and K2 (flash_attention_onepass.cu): one
// kernel template for Hopper (sm_90a), instantiated by each for its head
// dims; K2 takes it in its ONEPASS form (attention_tc_body below: a causal
// mode, several q tiles a CTA with K/V resident, swizzled wide TMA boxes).
//
// Function: non-causal softmax(Q K^T / sqrt(Dh)) V for every (batch, head),
// what the Pallas kernels _bsc_kernel and _streamed_kernel compute (and
// _onepass_kernel, with its causal mask):
//   * scores and softmax in fp32; log2(e)/sqrt(Dh) folded into the scale and
//     exp2 (ex2.approx, what exp2f is under fast math);
//   * an online softmax over KV tiles (running max m, sum l, accumulator);
//   * P rounded to bf16 before P V, as the Pallas kernels' p.astype(v.dtype);
//     the denominator l summed from the fp32 P;
//   * the KV tail of the last tile masked to -inf; a fully masked row guarded
//     (m = -inf is taken as 0, so exp2 never sees (-inf) - (-inf));
//   * output acc / max(l, 1e-30) in bf16; Sq and Sk of any length.
//
// Addressing.  q, k and v are read through TMA tensor maps of a 4-d
// (Dh, head, row, batch) view with a unit Dh stride and any 16-byte
// multiple for the other strides: K1's heads packed in channels are the case
// head stride = Dh (rows 3C apart in the fused q/k/v projection), K4's
// head-split (B, H, S, Dh) views the general case.  The output is written
// from registers with its own (batch, head, row) strides.
//
// Design (FlashAttention-3's warp-specialised schedule, written out by hand):
//   * one CTA of four warpgroups per (192 q rows, head, batch).  Warpgroup 0
//     is the producer: one thread issues every TMA load, and setmaxnreg
//     leaves it 24 registers a thread.  Warpgroups 1-3 are consumers of 64 q
//     rows each, with 160 registers a thread.  Where 192-row CTAs would not
//     fill the 132 SMs once (512² levels 2 and 3 at CFG batch 2), the launch
//     takes three warpgroups instead: two consumers of 64 rows, 240
//     registers a thread, more and smaller CTAs;
//   * Q is loaded once.  K and V tiles of BLOCK_N tokens (128 for Dh <= 80,
//     64 above) come through a ring of STAGES stages, as deep as fits in
//     shared memory up to 8 (8 at Dh 40, 4-5 at Dh 80, 4 at Dh 160), with a full
//     and an empty mbarrier each; the producer runs up to STAGES tiles ahead;
//   * S = Q K^T on wgmma m64nBLOCK_Nk16, both operands from shared memory
//     (K-major); O += P V on wgmma m64nDhk16 with P from registers (the S
//     accumulator, rounded to bf16, is already the A-fragment layout) and V
//     from shared memory as an MN-major operand (transpose bit);
//   * shared-memory layout (K1, K4): no swizzle.  Rows of 80 bytes (Dh 40)
//     or 160 bytes (Dh 80) fit no 32/64/128-byte swizzle pattern, so each
//     tile is stored as 8-column slabs ([slab][row][8 bf16]), each slab
//     filled by one 16-byte-wide TMA box: an 8x8 core matrix is 128
//     contiguous bytes (no bank conflicts within one), the next 8 rows 128
//     bytes on, the next 8 columns one slab on (descriptor LBO / SBO).  K2
//     stores swizzled atoms of 16, 32 or 64 columns instead, as many as cover
//     Dh, and lets TMA fill the columns past Dh with zeros (Cfg);
//   * Dh 40 is padded to 48 in the contraction of Q K^T: the pad slab of Q and
//     of every K stage is zeroed once in shared memory and never loaded, so
//     K1's packed layout never reads the next head's columns into it.  P V
//     runs at N = Dh (40 is a multiple of 8) and only Dh columns are stored.
//
// What bounds it on the H100.  Per (64-row, BLOCK_N-token) tile a warpgroup
// needs 2*64*BLOCK_N*(Dhp + Dh) FLOP on the tensor cores (~4k FLOP/clk/SM in
// bf16) and 64*BLOCK_N exp2 on the SFU (16/clk/SM).  At Dh 40 that is ~350
// clocks of MMA against 512 of exp2: on paper the exponential sets the floor
// (K4 at (2, 8, 65536, 40): 11.1 ms of MMA at 989 TFLOP/s, ~16-18 ms of
// exp2), and a design that ran softmax and MMA one after the other would pay
// the sum.  So:
//   * the consumer warpgroups take turns on named barriers: one issues its
//     wgmmas (S of tile j, P V of tile j-1) and hands over to the next, then
//     runs its exp2, max and sum while the others' wgmmas run;
//   * within a warpgroup the exp2 of tile j runs while P V of tile j-1 is in
//     flight; the rescale of O by exp2(m_old - m_new) waits for it and is
//     applied just before the next P V is issued;
//   * the scale is folded into one FFMA per score (exp2(s * c - m)), and l is
//     kept per thread and reduced across the quad once, at the end.
// On the card the exp2 turned out not to be the limit: taking a quarter of
// them off the SFU (a polynomial on the FMA pipe) or the P V products away
// changed the time by a few percent, while a shallower K/V ring made it much
// slower and a third consumer warpgroup (192 q rows sharing each K/V tile
// instead of 128) made it a quarter faster.  What holds it back is the K/V
// stream from L2: every q tile of a head reads the head's whole K and V, in
// 16-byte boxes, and TMA costs a request a box row.  K2's small grids, where
// a CTA walks its KV tiles alone, were bound by exactly that until K2 took
// wide swizzled atoms (PERF.md).  Left on the table for K1 and K4:
// the same atoms, thread-block clusters that share K/V tiles by TMA
// multicast, a persistent grid.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

namespace sdt_tc {

using bf16 = __nv_bfloat16;

constexpr int PRODUCER_REGS = 24;
constexpr int SCHED_BAR = 1;  // named barriers 1..NWG: "consumer w may issue"
constexpr int SMEM_CAP = 227 * 1024;
constexpr int MAX_STAGES = 8;

// NWG consumer warpgroups of 64 q rows.  Three make every K/V tile brought
// into shared memory serve 192 q rows, a third less L2 -> SM traffic per
// FLOP than two; two make more, smaller CTAs, which wins where the grid of
// 192-row tiles would not fill the SMs once (launch() chooses); one (K2 only)
// makes 64-row CTAs for grids that fill no more than one wave even so.
// QBUF Q buffers: one for K1 and K4 (a CTA owns one q tile); two for K2,
// whose CTAs may walk several q tiles (the next one's Q loads while this one
// computes).  SW: the shared-memory layout.  0 (K1, K4): 8-column slabs, one
// 16-byte-wide TMA box each, no swizzle.  16, 32 or 64 (K2): atoms of SW
// columns (32-, 64- or 128-byte rows, swizzled to match: TMA's
// SWIZZLE_32B/64B/128B and wgmma's descriptors), one TMA box each, as many
// as cover Dh; the columns past Dh are read as zeros by TMA.  A TMA box
// costs a request for every row, so wide atoms cut the requests of a tile
// two to eight times.
template <int DH, int NWG, int QBUF = 1, int SW = 0>
struct Cfg {
  static_assert(DH % 8 == 0, "head dim must be a multiple of 8");
  static_assert(NWG >= 1 && NWG <= 3, "one to three consumer warpgroups");
  static_assert(QBUF == 1 || QBUF == 2, "one or two Q buffers");
  static_assert(SW == 0 || SW == 16 || SW == 32 || SW == 64, "atoms of 16, 32 or 64 columns");
  static constexpr int BLOCK_M = 64 * NWG;
  static constexpr int THREADS = 128 * (NWG + 1);
  // one CTA an SM: THREADS threads of 65536 / THREADS registers (168 or
  // 128); setmaxnreg leaves the producer 24 and gives the consumers the rest.
  // One consumer warpgroup needs no setmaxnreg: 256 threads may have 255.
  static constexpr int CONSUMER_REGS = NWG == 3 ? 160 : 240;
  static_assert(NWG == 1 || 128 * PRODUCER_REGS + 128 * NWG * CONSUMER_REGS <=
                                (65536 / THREADS / 8 * 8) * THREADS, "registers");
  static constexpr int DHP = (DH + 15) / 16 * 16;  // contraction depth of Q K^T
  static constexpr int BLOCK_N = DH <= 80 ? 128 : 64;
  static constexpr int SLABS = SW ? (DH + SW - 1) / SW : DH / 8;  // boxes a row is loaded in
  static constexpr int PSLABS = SW ? SLABS : DHP / 8;  // slabs including the zero pad
  static constexpr int COLS = SW ? SW : 8;             // columns of a box
  static constexpr int ROW = 2 * COLS;                 // bytes of a box row in shared memory
  static constexpr int Q_BYTES = BLOCK_M * PSLABS * ROW;  // one Q buffer
  static constexpr int K_BYTES = BLOCK_N * PSLABS * ROW;  // one stage
  static constexpr int V_BYTES = BLOCK_N * SLABS * ROW;   // one stage
  static constexpr int Q_TX = BLOCK_M * SLABS * ROW;      // bytes TMA writes
  static constexpr int KV_TX = 2 * BLOCK_N * SLABS * ROW;
  // swizzled atoms must start on their pattern's period: the base is rounded
  // up to 1024 bytes at run time, and every buffer is a multiple of it
  static constexpr int ALIGN = SW ? 1024 : 0;
  // mbarriers besides the ring's: a full one for each Q buffer, and an empty
  // one for each where there are two
  static constexpr int Q_BARS = QBUF == 1 ? 1 : 2 * QBUF;
  // as deep a K/V ring as fits (the loads' latency is what the ring hides)
  static constexpr int FIT =
      (SMEM_CAP - ALIGN - QBUF * Q_BYTES - 8 * (2 * MAX_STAGES + Q_BARS)) / (K_BYTES + V_BYTES);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static_assert(STAGES >= 2, "shared memory");
  static constexpr int K_OFF = QBUF * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * V_BYTES;  // 8-byte mbarriers
  static constexpr int SMEM = ALIGN + BAR_OFF + 8 * (2 * STAGES + Q_BARS);
  static_assert(SMEM <= SMEM_CAP, "shared memory");
};

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait for the completion of the phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one 16-byte-wide box {8 cols, 1 head, rows, 1 batch} of a 4-d map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row),
      "r"(batch)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of wgmma operands across the
// fences and waits
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// shared-memory matrix descriptor, no swizzle: start address, LBO (the next
// core matrix along K), SBO (the next 8 rows along M or N), in bytes
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// the descriptor's layout field (bits 62-63) for atoms of SW columns: 0 no
// swizzle, 1 128-byte, 2 64-byte, 3 32-byte rows
template <int SW>
__host__ __device__ constexpr uint64_t swizzle_bits() {
  return static_cast<uint64_t>(SW == 64 ? 1 : SW == 32 ? 2 : SW == 16 ? 3 : 0) << 62;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------- kernel
// The body of every instantiation.  o_b, o_h, o_r: the output's batch, head
// and row strides (elements).  K1 and K4 (ONEPASS false) take one q tile a
// CTA, blockIdx.x, and walk every KV tile.  K2 (ONEPASS true) adds, at run
// time:
//   * causal: q tile qt walks only the KV tiles up to the one that holds its
//     last row (the rest are never loaded); in a tile that reaches past a
//     warp's first row, col > row is masked to -inf, row the absolute q
//     index.  Every consumer warpgroup of a CTA walks the same tiles, so the
//     turn-taking and the empty barriers stay as they are (a warp whose rows
//     all end before a tile gets P = 0 there);
//   * several q tiles a CTA: CTA x of a (head, batch) takes q tiles x,
//     x + gridDim.x, ...  The launch does so only where every KV tile the
//     CTA walks fits in the ring at once: they are loaded once, stage j
//     holding tile j, and stay resident while Q tiles come through two
//     buffers (q_full / q_empty), the next one loading while this one
//     computes.  (Skipping the exp2 of column groups no row of a warp may
//     see, past Sk or above the diagonal, was slower on the card at every
//     shape timed: the branches cost registers, and 192-row CTAs spilled.)
template <int DH, int NWG, bool ONEPASS, int SW = 0>
__device__ __forceinline__ void attention_tc_body(const CUtensorMap* tm_q,
                                                  const CUtensorMap* tm_k,
                                                  const CUtensorMap* tm_v,
                                                  bf16* __restrict__ o, long long o_b,
                                                  long long o_h, long long o_r, int sq,
                                                  int sk, float scale_log2, bool causal) {
  constexpr int QBUF = ONEPASS ? 2 : 1;
  using C = Cfg<DH, NWG, QBUF, SW>;
  constexpr int BLOCK_M = C::BLOCK_M, THREADS = C::THREADS;
  constexpr int STAGES = C::STAGES, BLOCK_N = C::BLOCK_N;
  constexpr int SN = BLOCK_N / 2;    // score accumulators a thread
  constexpr int ON = DH / 2;         // output accumulators a thread
  constexpr int PK = BLOCK_N / 16;   // k16 steps of P V
  constexpr int QK = C::DHP / 16;    // k16 steps of Q K^T
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = SW ? (smem_u32(smem) + C::ALIGN - 1) & ~(C::ALIGN - 1) : smem_u32(smem);
  const uint32_t q_s = base, k_s = base + C::K_OFF, v_s = base + C::V_OFF;
  const uint32_t full = base + C::BAR_OFF;         // STAGES barriers
  const uint32_t empty = full + 8 * STAGES;        // STAGES barriers
  const uint32_t q_full = empty + 8 * STAGES;      // QBUF barriers
  const uint32_t q_empty = q_full + 8 * QBUF;      // QBUF barriers (ONEPASS)

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int n_tiles = (sk + BLOCK_N - 1) / BLOCK_N;
  // this CTA's q tiles: blockIdx.x, blockIdx.x + q_step, ... below n_q
  const int n_q = ONEPASS ? (sq + BLOCK_M - 1) / BLOCK_M : blockIdx.x + 1;
  const int q_step = ONEPASS ? gridDim.x : 1;
  // the KV tiles q tile qt walks
  auto kv_tiles = [&](int qt) {
    if (!ONEPASS || !causal) return n_tiles;
    return min(n_tiles, (min((qt + 1) * BLOCK_M, sq) - 1) / BLOCK_N + 1);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NWG);  // one arrival per consumer warp
    }
    for (int b = 0; b < QBUF; ++b) {
      mbar_init(q_full + 8 * b, 1);
      if (ONEPASS) mbar_init(q_empty + 8 * b, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (C::PSLABS > C::SLABS) {  // zero the pad slabs of Q and of each K stage
    constexpr int PAD = (C::PSLABS - C::SLABS) * 8;
    for (int i = tid; i < QBUF * BLOCK_M * PAD / 8; i += THREADS) {
      const int b = i / (BLOCK_M * PAD / 8), r = i % (BLOCK_M * PAD / 8);
      reinterpret_cast<uint4*>(smem + b * C::Q_BYTES + C::SLABS * BLOCK_M * 16)[r] =
          make_uint4(0, 0, 0, 0);
    }
    for (int i = tid; i < STAGES * BLOCK_N * PAD / 8; i += THREADS) {
      const int s = i / (BLOCK_N * PAD / 8), r = i % (BLOCK_N * PAD / 8);
      reinterpret_cast<uint4*>(smem + C::K_OFF + s * C::K_BYTES +
                               C::SLABS * BLOCK_N * 16)[r] = make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ---------------------------------------------- producer
    if constexpr (NWG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      int loaded = 0;  // KV tiles issued: with several q tiles, those resident
      for (int i = 0, qt = blockIdx.x; qt < n_q; ++i, qt += q_step) {
        const int buf = i % QBUF;
        if (ONEPASS && i >= QBUF) mbar_wait(q_empty + 8 * buf, (i / QBUF - 1) & 1);
        mbar_expect_tx(q_full + 8 * buf, C::Q_TX);
        for (int s = 0; s < C::SLABS; ++s)
          tma_load(q_s + buf * C::Q_BYTES + s * BLOCK_M * C::ROW, tm_q, q_full + 8 * buf,
                   C::COLS * s, head, qt * BLOCK_M, batch);
        const int n = kv_tiles(qt);
        for (int j = loaded; j < n; ++j) {
          const int st = j % STAGES;
          if (j >= STAGES) mbar_wait(empty + 8 * st, (j / STAGES - 1) & 1);
          mbar_expect_tx(full + 8 * st, C::KV_TX);
          for (int s = 0; s < C::SLABS; ++s) {
            tma_load(k_s + st * C::K_BYTES + s * BLOCK_N * C::ROW, tm_k, full + 8 * st,
                     C::COLS * s, head, j * BLOCK_N, batch);
            tma_load(v_s + st * C::V_BYTES + s * BLOCK_N * C::ROW, tm_v, full + 8 * st,
                     C::COLS * s, head, j * BLOCK_N, batch);
          }
        }
        loaded = n;
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  if constexpr (NWG > 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
  const int w = wg - 1;            // consumer w: q rows 64w .. 64w+63 of a q tile
  const int next = (w + 1) % NWG;  // the consumer that issues after this one
  const int t = tid % 128;
  const int warp = t / 32, lane = t % 32;
  const bool signal = lane == 0;   // one empty-barrier arrival a warp

  float o_acc[ON];
#pragma unroll
  for (int i = 0; i < ON; ++i) o_acc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
  uint32_t p[PK][4];

  // S_j = Q K_j^T into s (issued, not waited for).  Q (A) and K (B) are
  // K-major.  Slabs: this warpgroup's 64 rows of each slab; slabs BLOCK_M *
  // 16 bytes apart along K, 8-row core matrices 128 bytes apart along M; a
  // k16 step is two slabs.  Atoms: 8-row groups 8 * ROW bytes apart; a k16
  // step is 32 bytes of an atom's row (the swizzle acts on the address).
  auto issue_s = [&](uint64_t q_desc, int st, float(&s)[SN]) {
    const uint64_t k_desc = SW ? make_desc(k_s + st * C::K_BYTES, 16, 8 * C::ROW) |
                                     swizzle_bits<SW>()
                               : make_desc(k_s + st * C::K_BYTES, BLOCK_N * 16, 128);
#pragma unroll
    for (int kk = 0; kk < QK; ++kk) {  // the slab or atom of the step, and its bytes into a row
      const int slab = SW ? 16 * kk / C::COLS : 2 * kk;
      const int in_row = SW ? 32 * kk % C::ROW : 0;
      sdt_wgmma::Mma<BLOCK_N>::ss(s, q_desc + ((slab * BLOCK_M * C::ROW + in_row) >> 4),
                                  k_desc + ((slab * BLOCK_N * C::ROW + in_row) >> 4), kk > 0);
    }
    wgmma_commit();
  };
  // O = O * alpha + P V_st (issued, not waited for)
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int i = 0; i < ON; ++i) o_acc[i] *= alpha[(i / 2) % 2];
    wgmma_fence();
    // V (B, MN-major: the transpose bit).  Slabs: the next 8 tokens 128
    // bytes on (LBO), the next 8 columns a slab on (SBO); 16 tokens are two
    // core matrices.  Atoms: the next SW columns an atom on (LBO), the next 8
    // tokens 8 * ROW bytes on (SBO); 16 tokens are 16 rows.
    const uint64_t v_desc = SW ? make_desc(v_s + st * C::V_BYTES, BLOCK_N * C::ROW, 8 * C::ROW) |
                                     swizzle_bits<SW>()
                               : make_desc(v_s + st * C::V_BYTES, 128, BLOCK_N * 16);
#pragma unroll
    for (int kk = 0; kk < PK; ++kk)
      sdt_wgmma::Mma<DH>::rs(o_acc, p[kk], v_desc + ((kk * 16 * (SW ? C::ROW : 16)) >> 4), 1);
    wgmma_commit();
  };
  // the online softmax of tile j on s (rows g and g + 8 of this warp's 16,
  // the first of which is row wrow): s becomes exp2(s * c - m_new), alpha
  // exp2(m_old - m_new)
  auto softmax = [&](int j, int wrow, float(&s)[SN]) {
    const int kv0 = j * BLOCK_N;
    if (kv0 + BLOCK_N > sk) {  // the KV tail
#pragma unroll
      for (int i = 0; i < SN; ++i) {
        const int col = kv0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        if (col >= sk) s[i] = -CUDART_INF_F;
      }
    }
    if constexpr (ONEPASS) {
      if (causal && kv0 + BLOCK_N - 1 > wrow) {  // the diagonal: col > row masked
#pragma unroll
        for (int i = 0; i < SN; ++i) {
          const int col = kv0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          if (col > wrow + lane / 4 + 8 * ((i / 2) % 2)) s[i] = -CUDART_INF_F;
        }
      }
    }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < SN / 4; ++i)
        mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale_log2);
      m_use[r] = m_new == -CUDART_INF_F ? 0.f : m_new;  // fully masked guard
      alpha[r] = exp2_approx(m[r] - m_use[r]);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < SN; ++i) {
      const int r = (i / 2) % 2;
      s[i] = exp2_approx(fmaf(s[i], scale_log2, -m_use[r]));
      sum[r] += s[i];
    }
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
  };
  auto pack_p = [&](const float(&s)[SN]) {
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  // Consumer w issues its wgmmas after bar_sync(SCHED_BAR + w) and hands the
  // tensor cores to the next with bar_arrive, in turn; consumer 0 goes
  // first.  So that every barrier completes as often as it is waited on, the
  // last consumer's final hand-over is skipped (K1, K4) or taken by
  // consumer 0 after its last q tile (K2: a hand-over under a condition
  // that depends on the q tile made ptxas serialize every wgmma, C7514).
  // One consumer takes no turns.  The first tile is peeled so that no
  // wgmma sits in a branch (ptxas serializes wgmmas in divergent code).
  if constexpr (NWG > 1) {
    if (w == NWG - 1) bar_arrive(SCHED_BAR, 256);
  }
  for (int i = 0, qt = blockIdx.x; qt < n_q; ++i, qt += q_step) {
    const int buf = i % QBUF;
    const bool last_q = qt + q_step >= n_q;
    const int n = kv_tiles(qt);
    const int wrow = qt * BLOCK_M + 64 * w + 16 * warp;  // this warp's first q row
    const uint64_t q_desc =
        SW ? make_desc(q_s + buf * C::Q_BYTES + w * 64 * C::ROW, 16, 8 * C::ROW) |
                 swizzle_bits<SW>()
           : make_desc(q_s + buf * C::Q_BYTES + w * 64 * 16, BLOCK_M * 16, 128);
    mbar_wait(q_full + 8 * buf, (i / QBUF) & 1);
    {
      float s[SN];
      mbar_wait(full, 0);
      if constexpr (NWG > 1) bar_sync(SCHED_BAR + w, 256);
      wgmma_fence();
      issue_s(q_desc, 0, s);
      if constexpr (NWG > 1) {
        if (ONEPASS || w != NWG - 1 || n > 1) bar_arrive(SCHED_BAR + next, 256);
      }
      wgmma_wait<0>();
      fence_regs(s);
      softmax(0, wrow, s);
      pack_p(s);
    }
    for (int j = 1; j < n; ++j) {
      const int st = j % STAGES;
      const int prev = (j - 1) % STAGES;
      float s[SN];
      mbar_wait(full + 8 * st, (j / STAGES) & 1);
      if constexpr (NWG > 1) bar_sync(SCHED_BAR + w, 256);
      wgmma_fence();
      issue_s(q_desc, st, s);
      issue_pv(prev);  // P_{j-1} V_{j-1}, in flight during this tile's exp2
      if constexpr (NWG > 1) {
        if (ONEPASS || w != NWG - 1 || j + 1 < n) bar_arrive(SCHED_BAR + next, 256);
      }
      wgmma_wait<1>();
      fence_regs(s);
      softmax(j, wrow, s);
      wgmma_wait<0>();  // P_{j-1} V_{j-1} done: its registers and stage are free
      fence_regs(o_acc);
      fence_regs(p);
      if (signal) mbar_arrive(empty + 8 * prev);
      pack_p(s);
    }
    if constexpr (ONEPASS) {  // every S of this q tile is done: its Q buffer is free
      if (signal) mbar_arrive(q_empty + 8 * buf);
    }
    {  // the last tile's P V
      const int last = (n - 1) % STAGES;
      issue_pv(last);
      wgmma_wait<0>();
      fence_regs(o_acc);
      fence_regs(p);
      if (signal) mbar_arrive(empty + 8 * last);
    }

    // epilogue: O / max(l, 1e-30), rows g and g + 8, bf16 pairs
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[r];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      const int row = wrow + lane / 4 + 8 * r;
      if (row >= sq) continue;
      bf16* orow = o + batch * o_b + head * o_h + row * o_r + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < ON / 4; ++i)
        *reinterpret_cast<uint32_t*>(orow + 8 * i) =
            pack_bf16(o_acc[4 * i + 2 * r] * inv, o_acc[4 * i + 2 * r + 1] * inv);
    }
    if constexpr (ONEPASS && NWG > 1) {
      if (last_q && w == 0) bar_sync(SCHED_BAR, 256);  // the last consumer's last hand-over
    }
    if constexpr (ONEPASS) {  // the next q tile starts afresh
#pragma unroll
      for (int i = 0; i < ON; ++i) o_acc[i] = 0.f;
      m[0] = m[1] = -CUDART_INF_F;
      l[0] = l[1] = 0.f;
    }
  }
}

// K1 and K4: one q tile a CTA, non-causal
template <int DH, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                    long long o_b, long long o_h, long long o_r, int sq, int sk,
                    float scale_log2) {
  attention_tc_body<DH, NWG, false>(&tm_q, &tm_k, &tm_v, o, o_b, o_h, o_r, sq, sk, scale_log2,
                                    false);
}

// ------------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the process has loaded (the build
// links no libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A 4-d map (Dh, head, row, batch) of a bf16 tensor with a unit Dh stride,
// boxes of {cols, 1, rows, 1} (8 columns and no swizzle unless asked);
// strides in elements.  A dim of size 1 takes a nominal stride (its stride
// is never used).  Rows past the end, and columns past Dh, read as 0.
inline bool make_map(CUtensorMap* map, const void* ptr, int dh, int heads, int seq, int batch,
                     long long s_h, long long s_r, long long s_b, int rows, int cols = 8,
                     CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {heads > 1 ? (cuuint64_t)s_h * 2 : 16,
                                 seq > 1 ? (cuuint64_t)s_r * 2 : 16,
                                 batch > 1 ? (cuuint64_t)s_b * 2 : 16};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH, int NWG>
cudaError_t launch_nwg(const void* q, const void* k, const void* v, void* o, const Strides& st,
                       int batch, int n_heads, int sq, int sk, cudaStream_t stream) {
  using C = Cfg<DH, NWG>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, DH, n_heads, sq, batch, st.q_h, st.q_r, st.q_b, C::BLOCK_M) ||
      !make_map(&tk, k, DH, n_heads, sk, batch, st.k_h, st.k_r, st.k_b, C::BLOCK_N) ||
      !make_map(&tv, v, DH, n_heads, sk, batch, st.v_h, st.v_r, st.v_b, C::BLOCK_N))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_tc_kernel<DH, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((sq + C::BLOCK_M - 1) / C::BLOCK_M, n_heads, batch);
  const float scale_log2 = LOG2E / sqrtf((float)DH);
  attention_tc_kernel<DH, NWG><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), st.o_b, st.o_h, st.o_r, sq, sk, scale_log2);
  return cudaGetLastError();
}

// q, k, v, o with (batch, head, row) strides `st` (elements) and a unit Dh
// stride; every pointer and stride a multiple of 16 bytes (the wrapper
// checks).  192-row CTAs where their grid fills the SMs at least once,
// 128-row CTAs below that.
template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const Strides& st,
                   int batch, int n_heads, int sq, int sk, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long ctas = (long long)((sq + 191) / 192) * n_heads * batch;
  return ctas >= sms ? launch_nwg<DH, 3>(q, k, v, o, st, batch, n_heads, sq, sk, stream)
                     : launch_nwg<DH, 2>(q, k, v, o, st, batch, n_heads, sq, sk, stream);
}

}  // namespace sdt_tc
