// K3: multi-pass flash attention, head-split (B, H, S, Dh), Dh up to 512, for Hopper.
//
// Replaces the Pallas kernel
//   pytorch_stable_diffusion_tpu/ops/pallas/flash_attention.py::flash_attention
//   (its multi-pass grid :615, body: _kernel :137).
// It computes what that kernel computes, softmax(Q K^T / sqrt(Dh)) V for every
// (batch, head), causal or not, over a KV of any length:
//   * scores and softmax in fp32; 1/sqrt(Dh) (the true Dh) folded with log2(e)
//     into exp2; P rounded to the input dtype before P V, as the Pallas
//     kernel's p.astype(v.dtype), the denominator summed from the fp32 P;
//   * causal mask col <= row; the KV tail of the last tile masked;
//   * output acc / max(l, 1e-30) in the input dtype, so a row masked in every
//     tile gives 0 (m = -inf is guarded: exp2 of (-inf) - (-inf) would be NaN).
// The TPU grid's sequential kv axis, with m, l and acc carried in VMEM
// scratch from one grid step to the next, becomes a loop over KV tiles inside
// one CTA.  Causal: KV tiles wholly above the diagonal are skipped.
//
// Head dims: every multiple of 8 up to 512.  The bf16 kernel is built for
// padded widths DHP = 128, 256 and 512: its tensor maps carry the true Dh,
// so TMA fills the columns past it with zeros (they add 0 to the scores and
// produce output columns that are never stored).  The fp32 kernel is built
// for 64, 128, 256 and 512 and zero-fills the same way with cp.async.
//
// What bounds it on the H100.  At SD-1.5's 2048² VAE mid block,
// (1, 1, 65536, 512), a call costs 4*Sq*Sk*Dh = 8.8 TFLOP (8.9 ms at 989
// TFLOP/s) against 0.27 GB of HBM (0.08 ms) and 4.3 G exp2 (1.03 ms): the
// products bound it.  Dh 512 breaks the usual flash-attention plan twice:
//   * registers: a 64-row fp32 O tile is 128 KB, 256 registers a thread of
//     one warpgroup;
//   * the K/V stream: every q tile reads the head's whole K and V (134 MB at
//     65536 tokens), more than the 50 MB L2.  With 64-row q tiles a call
//     reads 1024 x 134 MB = 137 GB from L2 into shared memory; at the ~3.1
//     TB/s measured for K4's stream (flash_attention_tc.cuh) that alone
//     would take ~44 ms.  On the H100 it does not: with no sharing the kernel
//     runs at 374 TFLOP/s (23.5 ms), the stream at ~5.6 TB/s from L2.
//
// bf16 design (wgmma + TMA, one CTA of three warpgroups per 64 q rows):
//   * Dh split across two consumer warpgroups.  Warpgroup w owns columns
//     [w*DHP/2, (w+1)*DHP/2) of O (128 fp32 registers a thread at Dh 512)
//     and computes the partial scores S_w = Q[:, cols_w] K[:, cols_w]^T of
//     each 32-token tile (wgmma m64n32k16, Q and K from shared memory);
//   * the two partials meet in shared memory (2 x 64 x 32 fp32); 256
//     consumer threads, four to a row, each sum 8 scores, apply the mask
//     and the online softmax (running m and l per row; rescale factors to
//     shared memory) and write P in bf16 to shared memory (the no-swizzle
//     core-matrix layout: one 16-byte row of a core matrix a thread);
//   * each warpgroup rescales its O and runs O += P V[:, cols_w] (wgmma
//     m64nDHP/2k16, P and V from shared memory, V MN-major);
//   * a producer warpgroup (setmaxnreg 24) issues TMA loads into a ring of
//     K and V units (one 32-token tile of K or of V each), 4 units at Dh
//     512, with a full and an empty mbarrier each;
//   * no K/V sharing among q tiles: thread-block clusters of two and four
//     sharing each K/V unit by TMA multicast (137 GB -> 34 GB a call) ran
//     slower on the H100 (PERF.md §6), since the stream is not the limit
//     at this speed and a cluster ties its CTAs to the slowest one's ring;
//   * 128-byte swizzle for Q, K and V (a 64-column box is one 128-byte
//     swizzle row; descriptors with SBO 1024, K steps of 32 bytes);
//   * small grids: (1, 1, 4096, 512), the 512² VAE on the kernel backend,
//     gives 64 CTAs for 132 SMs; chip_smoke.py times it.
//   * S of tile j and P V of tile j-1 are issued together, so P V runs on
//     the tensor cores while the warpgroups exchange tile j's scores and
//     take their exponentials (P double-buffered in shared memory).
// Left on the table: a deeper ring, and the shared-memory traffic of the
// score exchange (2 x 8 KB written and read a tile).
//
// fp32 path (the FP32 policy's checks need full fp32: no TF32): a CUDA-core
// kernel, one CTA of 256 threads per (32-row q tile, head, batch),
// Q, K and V staged by cp.async, P through shared memory.
#include <math_constants.h>

#include "common.cuh"
#include "flash_attention_tc.cuh"

namespace {

// ============================================================ bf16 (wgmma)
namespace tc {

using bf16 = __nv_bfloat16;
using sdt_tc::bar_sync;
using sdt_tc::exp2_approx;
using sdt_tc::fence_regs;
using sdt_tc::mbar_arrive;
using sdt_tc::mbar_expect_tx;
using sdt_tc::mbar_init;
using sdt_tc::mbar_wait;
using sdt_tc::smem_u32;
using sdt_tc::wgmma_commit;
using sdt_tc::wgmma_fence;
using sdt_tc::wgmma_wait;

constexpr int BM = 64;           // q rows a CTA
constexpr int BN = 32;           // KV tokens a tile
constexpr int NWG = 2;           // consumer warpgroups, a half of the padded Dh each
constexpr int THREADS = 128 * (NWG + 1);
constexpr int CONSUMERS = 128 * NWG;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int RED_PITCH = BN + 8;  // floats: the 8 rows a partial store touches, 2 wavefronts
constexpr int MAX_STAGES = 8;
constexpr int SMEM_CAP = 227 * 1024;
constexpr int CONSUMER_BAR = 1;  // named barrier of the 256 consumer threads

template <int DHP>
struct Cfg {
  static_assert(DHP % 128 == 0 && DHP <= 512, "padded head dim");
  static constexpr int DW = DHP / NWG;         // O columns a consumer warpgroup
  static constexpr int CHUNKS = DHP / 64;      // 64-column boxes (128-byte rows)
  static constexpr int Q_BYTES = BM * DHP * 2;
  static constexpr int UNIT = BN * DHP * 2;    // one tile of K or of V
  static constexpr int Q_CHUNK = BM * 128, U_CHUNK = BN * 128;
  static constexpr int RED_BYTES = NWG * BM * RED_PITCH * 4;
  static constexpr int P_BYTES = BM * BN * 2;  // one of two P buffers
  static constexpr int FIXED = 1024 + Q_BYTES + RED_BYTES + 2 * P_BYTES + 2 * BM * 4 +
                               8 * (2 * MAX_STAGES + 1);
  static constexpr int FIT = (SMEM_CAP - FIXED) / UNIT;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static_assert(STAGES >= 2, "shared memory");
  // offsets from the 1024-byte aligned base
  static constexpr int U_OFF = Q_BYTES;
  static constexpr int RED_OFF = U_OFF + STAGES * UNIT;
  static constexpr int P_OFF = RED_OFF + RED_BYTES;
  static constexpr int ALPHA_OFF = P_OFF + 2 * P_BYTES;
  static constexpr int L_OFF = ALPHA_OFF + BM * 4;
  static constexpr int BAR_OFF = L_OFF + BM * 4;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (2 * STAGES + 1);
  static_assert(SMEM <= SMEM_CAP, "shared memory");
};

// 128-byte-swizzled operand (rows of 64 bf16, 8-row atoms of 1024 bytes):
// K-major A or B (SBO = the next 8 rows), or MN-major B (LBO = the next 64
// columns, SBO = the next 8 K rows)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return sdt_tc::make_desc(addr, lbo, sbo) | (1ull << 62);
}

// o_b, o_h, o_r: the output's strides (elements); dh: the true head dim
template <int DHP>
__global__ void __launch_bounds__(THREADS, 1)
multipass_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                    long long o_b, long long o_h, long long o_r, int sq, int sk, int dh,
                    int causal, float scale_log2) {
  using C = Cfg<DHP>;
  constexpr int STAGES = C::STAGES, DW = C::DW;
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const uint32_t raw = smem_u32(smem_tc);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_tc + (base - raw);
  const uint32_t q_s = base, u_s = base + C::U_OFF, p_s = base + C::P_OFF;
  float* red = reinterpret_cast<float*>(smem + C::RED_OFF);
  float* alpha_s = reinterpret_cast<float*>(smem + C::ALPHA_OFF);
  float* l_s = reinterpret_cast<float*>(smem + C::L_OFF);
  const uint32_t full = base + C::BAR_OFF;  // STAGES barriers
  const uint32_t empty = full + 8 * STAGES;  // STAGES barriers
  const uint32_t q_full = empty + 8 * STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int q0 = blockIdx.x * BM;
  int n_tiles = (sk + BN - 1) / BN;
  if (causal) {  // skip the tiles wholly above the diagonal
    const int last = min(q0 + BM, sq) - 1;
    n_tiles = min(n_tiles, last / BN + 1);
  }

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NWG);  // one arrival per consumer warp
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ---------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < C::CHUNKS; ++c)
        sdt_tc::tma_load(q_s + c * C::Q_CHUNK, &tm_q, q_full, 64 * c, head, q0, batch);
      for (int u = 0; u < 2 * n_tiles; ++u) {  // unit 2j: K of tile j; 2j + 1: V
        const int st = u % STAGES;
        if (u >= STAGES) mbar_wait(empty + 8 * st, (u / STAGES - 1) & 1);
        mbar_expect_tx(full + 8 * st, C::UNIT);
        const CUtensorMap* map = (u & 1) ? &tm_v : &tm_k;
        for (int c = 0; c < C::CHUNKS; ++c)
          sdt_tc::tma_load(u_s + st * C::UNIT + c * C::U_CHUNK, map, full + 8 * st, 64 * c, head,
                           (u / 2) * BN, batch);
      }
    }
    __syncwarp();
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int w = wg - 1;  // O columns [w * DW, (w + 1) * DW)
  const int t = tid % 128, ct = tid - 128;
  const int warp = t / 32, lane = t % 32;
  // the softmax role: row rr, tile columns cc .. cc + 7
  const int rr = ct / 4, cc = (ct % 4) * 8;
  const int qrow = q0 + rr;

  float o_acc[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) o_acc[i] = 0.f;
  float m_run = -CUDART_INF_F, l_run = 0.f;

  auto release = [&](int st) {  // this warp is done with stage st
    if (lane == 0) mbar_arrive(empty + 8 * st);
  };

  float s[BN / 2];
  // S_j (partial) = Q[:, cols_w] K_j[:, cols_w]^T, issued, not waited for
  auto issue_s = [&](int j) {
    const int u = 2 * j, st = u % STAGES;
    mbar_wait(full + 8 * st, (u / STAGES) & 1);
#pragma unroll
    for (int kk = 0; kk < DW / 16; ++kk) {
      const int col = w * DW + 16 * kk;  // 64-column chunk col / 64, 32-byte step in it
      const uint32_t off = (col % 64) * 2;
      const uint64_t a = desc_sw128(q_s + (col / 64) * C::Q_CHUNK + off, 16, 1024);
      const uint64_t b = desc_sw128(u_s + st * C::UNIT + (col / 64) * C::U_CHUNK + off, 16,
                                    1024);
      sdt_wgmma::MmaSS<BN, 0>::run(s, a, b, kk > 0);
    }
    wgmma_commit();
  };
  // O = O * alpha + P_j V_j[:, cols_w], issued, not waited for
  auto issue_pv = [&](int j) {
    const int u = 2 * j + 1, st = u % STAGES;
    const float a0 = alpha_s[16 * warp + lane / 4], a1 = alpha_s[16 * warp + lane / 4 + 8];
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) o_acc[i] *= (i / 2) % 2 ? a1 : a0;
    mbar_wait(full + 8 * st, (u / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t a = sdt_tc::make_desc(p_s + (j % 2) * C::P_BYTES + kk * 2 * BM * 16,
                                           BM * 16, 128);
      const uint64_t b = desc_sw128(u_s + st * C::UNIT + (w * DW / 64) * C::U_CHUNK +
                                        kk * 16 * 128,
                                    C::U_CHUNK, 1024);
      sdt_wgmma::MmaSS<DW, 1>::run(o_acc, a, b, 1);
    }
    wgmma_commit();
  };
  // S_j done: the score exchange and the online softmax of tile j (row rr,
  // columns cc .. cc + 7), P_j to buffer j % 2 and its rescale factors
  auto softmax = [&](int j) {
    fence_regs(s);
    release((2 * j) % STAGES);
    {  // the partial scores: rows 16 warp + lane / 4 (+ 8), columns 8 i + 2 (lane % 4) (+ 1)
      float* dst = red + w * BM * RED_PITCH;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * warp + lane / 4 + 8 * r, col = 8 * i + 2 * (lane % 4);
          *reinterpret_cast<float2*>(dst + row * RED_PITCH + col) =
              make_float2(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]);
        }
    }
    bar_sync(CONSUMER_BAR, CONSUMERS);
    float x[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a = *reinterpret_cast<const float4*>(red + rr * RED_PITCH + cc + 4 * h);
      const float4 b =
          *reinterpret_cast<const float4*>(red + (BM + rr) * RED_PITCH + cc + 4 * h);
      x[4 * h] = a.x + b.x;
      x[4 * h + 1] = a.y + b.y;
      x[4 * h + 2] = a.z + b.z;
      x[4 * h + 3] = a.w + b.w;
    }
    const int kv0 = j * BN + cc;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = kv0 + e;
      if (col >= sk || (causal && col > qrow)) x[e] = -CUDART_INF_F;
      mx = fmaxf(mx, x[e]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx * scale_log2);
    const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;  // fully masked guard
    const float alpha = exp2_approx(m_run - m_use);
    m_run = m_new;
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      x[e] = exp2_approx(fmaf(x[e], scale_log2, -m_use));
      sum += x[e];
    }
    l_run = l_run * alpha + sum;
    // P, no-swizzle K-major core matrices: [8-token slab][row][8 tokens]
    uint4 pk;
    pk.x = sdt_tc::pack_bf16(x[0], x[1]);
    pk.y = sdt_tc::pack_bf16(x[2], x[3]);
    pk.z = sdt_tc::pack_bf16(x[4], x[5]);
    pk.w = sdt_tc::pack_bf16(x[6], x[7]);
    *reinterpret_cast<uint4*>(smem + C::P_OFF + (j % 2) * C::P_BYTES + (cc / 8) * BM * 16 +
                              rr * 16) = pk;
    if (ct % 4 == 0) alpha_s[rr] = alpha;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // P -> wgmma
    bar_sync(CONSUMER_BAR, CONSUMERS);
  };

  // Tile j issues S_j and P_{j-1} V_{j-1} together; P_{j-1} V_{j-1} runs on
  // the tensor cores during tile j's score exchange and softmax.  Every
  // iteration ends with no wgmma in flight (O is rescaled between them),
  // and the first tile is peeled, so that no wgmma sits in a branch: ptxas
  // serializes wgmmas otherwise.
  mbar_wait(q_full, 0);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  softmax(0);
  for (int j = 1; j < n_tiles; ++j) {
    wgmma_fence();
    issue_s(j);
    issue_pv(j - 1);  // rescales O by tile j-1's factors, fences, issues
    wgmma_wait<1>();  // S_j (P_{j-1} V_{j-1} may run on)
    softmax(j);
    wgmma_wait<0>();
    fence_regs(o_acc);
    release((2 * j - 1) % STAGES);
  }
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs(o_acc);
  release((2 * n_tiles - 1) % STAGES);

  // epilogue: l of each row to shared memory, O / max(l, 1e-30) in bf16
  float lt = l_run;
  lt += __shfl_xor_sync(0xffffffffu, lt, 1);
  lt += __shfl_xor_sync(0xffffffffu, lt, 2);
  if (ct % 4 == 0) l_s[rr] = lt;
  bar_sync(CONSUMER_BAR, CONSUMERS);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lrow = 16 * warp + lane / 4 + 8 * r;
    const int row = q0 + lrow;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l_s[lrow], 1e-30f);
    bf16* orow = o + batch * o_b + head * o_h + row * o_r;
#pragma unroll
    for (int i = 0; i < DW / 8; ++i) {
      const int col = w * DW + 8 * i + 2 * (lane % 4);
      if (col < dh)
        *reinterpret_cast<uint32_t*>(orow + col) =
            sdt_tc::pack_bf16(o_acc[4 * i + 2 * r] * inv, o_acc[4 * i + 2 * r + 1] * inv);
    }
  }
}

template <int DHP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const Strides& st,
                   int batch, int n_heads, int sq, int sk, int dh, int causal,
                   cudaStream_t stream) {
  using C = Cfg<DHP>;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tq, tk, tv;
  if (!sdt_tc::make_map(&tq, q, dh, n_heads, sq, batch, st.q_h, st.q_r, st.q_b, BM, 64, sw) ||
      !sdt_tc::make_map(&tk, k, dh, n_heads, sk, batch, st.k_h, st.k_r, st.k_b, BN, 64, sw) ||
      !sdt_tc::make_map(&tv, v, dh, n_heads, sk, batch, st.v_h, st.v_r, st.v_b, BN, 64, sw))
    return cudaErrorInvalidValue;
  auto kernel = multipass_tc_kernel<DHP>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((sq + BM - 1) / BM, n_heads, batch);
  const float scale_log2 = LOG2E / sqrtf((float)dh);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv, static_cast<bf16*>(o), st.o_b, st.o_h,
                                             st.o_r, sq, sk, dh, causal, scale_log2);
  return cudaGetLastError();
}

// the launch configuration of the kernel for padded width DHP: ring stages,
// dynamic shared memory and resident CTAs an SM
template <int DHP>
cudaError_t config(int* stages, int* smem, int* ctas) {
  using C = Cfg<DHP>;
  *stages = C::STAGES;
  *smem = C::SMEM;
  auto kernel = multipass_tc_kernel<DHP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  return err != cudaSuccess
             ? err
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, THREADS, C::SMEM);
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, const Strides& st,
                     int batch, int n_heads, int sq, int sk, int dh, int causal,
                     cudaStream_t stream) {
  if (dh <= 128) return launch<128>(q, k, v, o, st, batch, n_heads, sq, sk, dh, causal, stream);
  if (dh <= 256) return launch<256>(q, k, v, o, st, batch, n_heads, sq, sk, dh, causal, stream);
  return launch<512>(q, k, v, o, st, batch, n_heads, sq, sk, dh, causal, stream);
}

}  // namespace tc

// ========================================================= fp32 (CUDA cores)
constexpr int BLOCK_M = 32;   // q rows per CTA
constexpr int BLOCK_N = 32;   // KV rows per tile
constexpr int THREADS = 256;
constexpr int S_ROWS = 2;     // score rows per thread: ty + 16 * i
constexpr int S_COLS = 2;     // score columns per thread: tx + 16 * j
constexpr int PV_ROWS = 8;    // P V rows per thread: pr + 4 * i
constexpr int P_STRIDE = BLOCK_N + 16;  // the two P rows a warp writes hit distinct banks

// 16 bytes of shared memory as fp32 values
__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  x[0] = r.x;
  x[1] = r.y;
  x[2] = r.z;
  x[3] = r.w;
}

// Shared-memory layout.  Q and K rows are QK = Dh + one 16-byte chunk apart:
// an odd number of chunks, so the 16 K rows a half-warp reads 16 bytes of at
// one column spread over all banks.
template <int DH>
struct Layout {
  static_assert(DH % 64 == 0, "head dim must be a multiple of 64");
  static constexpr int VEC = 4;  // fp32 elements per 16-byte chunk
  static constexpr int QK = DH + VEC;
  static constexpr int Q_ELEMS = BLOCK_M * QK;
  static constexpr int K_ELEMS = BLOCK_N * QK;
  static constexpr int V_ELEMS = BLOCK_N * DH;
  static constexpr size_t TILE_BYTES = sizeof(float) * (size_t)(Q_ELEMS + K_ELEMS + V_ELEMS);
  static constexpr size_t SMEM = TILE_BYTES + sizeof(float) * (BLOCK_M * P_STRIDE + 2 * BLOCK_M);
};

// Start the copies of rows [row0, row0 + TILE) of a (rows, dh) matrix with row
// stride `rs` (elements) into a shared tile of DH columns with row stride LD;
// rows >= n_rows and columns >= dh read as 0.
template <int DH, int LD, int TILE>
__device__ __forceinline__ void load_tile_cols(float* dst, const float* src, long long rs,
                                               int row0, int n_rows, int dh, int tid) {
  constexpr int CPR = DH / 4;  // 16-byte chunks per row
  for (int c = tid; c < TILE * CPR; c += THREADS) {
    const int r = c / CPR, ch = c - r * CPR;
    const int row = row0 + r;
    const bool ok = row < n_rows && ch * 4 < dh;
    const float* g = ok ? src + (long long)row * rs + ch * 4 : src;
    cp_async16(dst + r * LD + ch * 4, g, ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
multipass_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, Strides st, int sq,
                      int sk, int dh, int causal, float scale_log2) {
  using L = Layout<DH>;
  constexpr int QK = L::QK;
  constexpr int VEC = L::VEC;
  constexpr int PV_COLS = DH / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + L::Q_ELEMS;
  float* Vs = Ks + L::K_ELEMS;
  float* Ps = reinterpret_cast<float*>(smem_raw + L::TILE_BYTES);
  float* alpha_s = Ps + BLOCK_M * P_STRIDE;  // per-row rescale of this tile
  float* l_s = alpha_s + BLOCK_M;            // per-row denominators at the end

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // scores
  const int pr = tid >> 6, pc = tid & 63;  // P V
  const long long h = blockIdx.y;
  const long long b = blockIdx.z;
  const int q0 = blockIdx.x * BLOCK_M;
  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h;

  load_tile_cols<DH, QK, BLOCK_M>(Qs, qb, st.q_r, q0, sq, dh, tid);
  cp_async_commit();

  int n_tiles = (sk + BLOCK_N - 1) / BLOCK_N;
  if (causal) {  // skip the tiles wholly above the diagonal
    const int last_row = min(q0 + BLOCK_M, sq) - 1;
    n_tiles = min(n_tiles, last_row / BLOCK_N + 1);
  }

  float m[S_ROWS], l[S_ROWS], acc[PV_ROWS][PV_COLS];
#pragma unroll
  for (int i = 0; i < S_ROWS; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < PV_ROWS; ++i)
#pragma unroll
    for (int c = 0; c < PV_COLS; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * BLOCK_N;
    __syncthreads();  // the previous tile's K/V/P reads are done
    load_tile_cols<DH, QK, BLOCK_N>(Ks, kb, st.k_r, kv0, sk, dh, tid);
    load_tile_cols<DH, DH, BLOCK_N>(Vs, vb, st.v_r, kv0, sk, dh, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T for this thread's 2x2 tile, 16 bytes of Q and K at a time
    float s[S_ROWS][S_COLS];
#pragma unroll
    for (int i = 0; i < S_ROWS; ++i)
#pragma unroll
      for (int j = 0; j < S_COLS; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; d += VEC) {
      float qv[S_ROWS][VEC], kv[S_COLS][VEC];
#pragma unroll
      for (int i = 0; i < S_ROWS; ++i) load_vec(Qs + (ty + 16 * i) * QK + d, qv[i]);
#pragma unroll
      for (int j = 0; j < S_COLS; ++j) load_vec(Ks + (tx + 16 * j) * QK + d, kv[j]);
#pragma unroll
      for (int i = 0; i < S_ROWS; ++i)
#pragma unroll
        for (int j = 0; j < S_COLS; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e) s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
    }

    // online softmax: scale, mask, merge with the running stats
#pragma unroll
    for (int i = 0; i < S_ROWS; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < S_COLS; ++j) {
        const int col = kv0 + tx + 16 * j;
        const bool ok = col < sk && (!causal || col <= row);
        s[i][j] = ok ? s[i][j] * scale_log2 : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;  // fully masked guard
      const float alpha = exp2f(m[i] - m_use);
      float rs = 0.f;
      float* prow = Ps + (ty + 16 * i) * P_STRIDE;
#pragma unroll
      for (int j = 0; j < S_COLS; ++j) {
        const float p = exp2f(s[i][j] - m_use);
        rs += p;
        prow[tx + 16 * j] = p;
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
      if (tx == 0) alpha_s[ty + 16 * i] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V over this tile's valid rows
#pragma unroll
    for (int i = 0; i < PV_ROWS; ++i) {
      const float a = alpha_s[pr + 4 * i];
#pragma unroll
      for (int c = 0; c < PV_COLS; ++c) acc[i][c] *= a;
    }
    const int n_valid = min(BLOCK_N, sk - kv0);
    for (int n = 0; n < n_valid; ++n) {
      float pv[PV_ROWS];
#pragma unroll
      for (int i = 0; i < PV_ROWS; ++i) pv[i] = Ps[(pr + 4 * i) * P_STRIDE + n];
#pragma unroll
      for (int c = 0; c < PV_COLS; ++c) {
        const float vv = Vs[n * DH + pc + 64 * c];
#pragma unroll
        for (int i = 0; i < PV_ROWS; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < S_ROWS; ++i) l_s[ty + 16 * i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PV_ROWS; ++i) {
    const int row = q0 + pr + 4 * i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l_s[pr + 4 * i], 1e-30f);
    float* orow = o + b * st.o_b + h * st.o_h + (long long)row * st.o_r;
#pragma unroll
    for (int c = 0; c < PV_COLS; ++c)
      if (pc + 64 * c < dh) orow[pc + 64 * c] = acc[i][c] * inv;
  }
}

template <int DH>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o, const Strides& st,
                        int batch, int n_heads, int sq, int sk, int dh, int causal,
                        cudaStream_t stream) {
  const size_t smem = Layout<DH>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(multipass_fp32_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, n_heads, batch);
  const float scale_log2 = LOG2E / sqrtf((float)dh);
  multipass_fp32_kernel<DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), st, sq, sk, dh, causal, scale_log2);
  return cudaGetLastError();
}

cudaError_t dispatch_fp32(const void* q, const void* k, const void* v, void* o,
                          const Strides& st, int batch, int n_heads, int sq, int sk, int dh,
                          int causal, cudaStream_t stream) {
  if (dh <= 64) return launch_fp32<64>(q, k, v, o, st, batch, n_heads, sq, sk, dh, causal, stream);
  if (dh <= 128)
    return launch_fp32<128>(q, k, v, o, st, batch, n_heads, sq, sk, dh, causal, stream);
  if (dh <= 256)
    return launch_fp32<256>(q, k, v, o, st, batch, n_heads, sq, sk, dh, causal, stream);
  return launch_fp32<512>(q, k, v, o, st, batch, n_heads, sq, sk, dh, causal, stream);
}

}  // namespace

extern "C" {

// strides: 12 values in elements, (batch, head, row) for q, k, v, o in that
// order; the head-dim stride is 1, every other stride and each pointer a
// multiple of 16 bytes.  head_dim: a multiple of 8 up to 512.  dtype: 0 =
// float32, 1 = bfloat16; causal: 0 or 1.  Returns the cudaError_t of the
// launch (0 on success); never synchronizes.
int sdt_flash_attention_multipass(const void* q, const void* k, const void* v, void* o,
                                  const long long* strides, int batch, int n_heads, int sq,
                                  int sk, int head_dim, int dtype, int causal,
                                  void* stream) {
  if (batch <= 0 || sq <= 0 || n_heads <= 0) return cudaSuccess;
  if (sk <= 0 || n_heads > 65535 || batch > 65535) return cudaErrorInvalidValue;
  if (head_dim <= 0 || head_dim > 512 || head_dim % 8) return cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],  strides[5],
                   strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_fp32(q, k, v, o, st, batch, n_heads, sq, sk, head_dim, causal, s);
  if (dtype == 1)
    return tc::dispatch(q, k, v, o, st, batch, n_heads, sq, sk, head_dim, causal, s);
  return cudaErrorInvalidValue;
}

// The bf16 kernel's launch configuration at head dim `head_dim` (padded as a
// call pads it): ring stages, dynamic shared memory (bytes) and CTAs an SM.
// Returns a cudaError_t.
int sdt_flash_attention_multipass_config(int head_dim, int* stages, int* smem, int* ctas) {
  if (head_dim <= 0 || head_dim > 512) return cudaErrorInvalidValue;
  if (head_dim <= 128) return tc::config<128>(stages, smem, ctas);
  if (head_dim <= 256) return tc::config<256>(stages, smem, ctas);
  return tc::config<512>(stages, smem, ctas);
}

}  // extern "C"
