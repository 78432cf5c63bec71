// K2: one-pass flash attention, head-split (B, H, S, Dh), causal or not, for Hopper.
//
// Replaces the Pallas kernel
//   pytorch_stable_diffusion_tpu/ops/pallas/flash_attention.py::flash_attention
//   (its one-pass call, :587; body: _onepass_kernel :179, with the chunk
//   statistics of _chunk_softmax_stats :75).
// It computes what that kernel computes, softmax(Q K^T / sqrt(Dh)) V for every
// (batch, head), over a KV of up to 9216 tokens (the router's bound; the
// kernel itself takes any length):
//   * scores and softmax in fp32; 1/sqrt(Dh) folded with log2(e) and exp2,
//     as the TPU kernel's log2-space logits;
//   * optional causal mask col <= row; the KV tail of the last tile masked;
//   * P rounded to the input dtype before P V (the TPU kernel's
//     p.astype(v.dtype)), the denominator l summed from the fp32 P;
//   * output acc / max(l, 1e-30) in the input dtype, so a row whose every
//     score is masked gives 0 (m = -inf is guarded: exp2 of (-inf) - (-inf)
//     would be NaN; masked scores are -inf, so their exp2 is exactly 0).
//
// What is kept of the TPU kernel, and what is not.  On the TPU the whole
// padded KV of one (batch, head) sits in VMEM, cut into independent chunks
// merged in closed form so that the MXU overlaps the VPU's exp.  Here the KV
// is walked with an online softmax (the same merge, one tile at a time).
//
// bf16 path: the wgmma + TMA template of K1 and K4 (flash_attention_tc.cuh:
// a producer warpgroup, consumer warpgroups of 64 q rows taking turns on the
// tensor cores, K/V tiles through an mbarrier ring, P V with P from
// registers), in its ONEPASS form: a causal mode, several q tiles a CTA with
// the head's K/V resident in the ring, and shared memory in swizzled atoms
// of 16, 32 or 64 columns (atom_of) filled by TMA boxes of 32 to 128-byte
// rows.  The launch picks one of three schedules by shape (plan()):
//   * small grid: where every 64-row q tile of the call fits on the SMs in
//     one wave (SD-1.5 512² level 3 and the mid block at CFG batch 2: 64
//     and 16 tiles), one consumer warpgroup a CTA, so that the SMs that
//     128-row CTAs would leave idle take half the rows each;
//   * resident: where the KV tiles fit in the ring at once (308 tokens are
//     three 128-token stages at Dh 40 and 80), about one CTA an SM, each
//     walking several q tiles of one (batch, head): K/V are loaded once
//     instead of once a q tile, and a q tile's Q loads while the previous
//     one computes;
//   * streamed: otherwise (up to 9216 tokens), one q tile a CTA and K/V
//     streamed through the ring, as K1 and K4 run.
// sdt_flash_attention_onepass_config reports the schedule of a call.
// fp32 path (the FP32 policy's checks): K4's CUDA-core design
// (csrc/flash_attention_streamed.cu) with the causal mask: thread (rg, cg)
// owns q rows rg + 16*i and score columns cg + 8*j, P goes through shared
// memory; no TF32.
//
// Strides.  q, k, v and the output are taken with their own batch, head and
// row strides (elements, 64-bit offsets) and a unit head-dim stride: the
// UNet passes its q projection and its fused k/v projection of the context
// (rows 2C apart) viewed as (B, H, S, Dh) without a copy, and the wrapper's
// output is (B, S, H, Dh) memory, so merging the heads is free.  The bf16
// path reads them through TMA: pointers and strides must be multiples of 16
// bytes (the wrapper checks).
//
// What bounds it on the H100.  SD-1.5's level-1 cross-attention under a
// 4-window prompt, (2, 8, 4096, 40) x KV 308, costs 4*Sq*Sk*Dh*B*H = 3.2
// GFLOP (3.3 us at 989 TFLOP/s), must move ~11 MB in bf16 (q and out 10.5
// MB, k and v 0.4 MB; 3.4 us at 3.35 TB/s) and needs 20.2 M exp2 (4.8 us at
// 16 a clock on 132 SMs): the exponential sets the floor.  On the card
// (PERF.md) the call takes about four times that: each q tile walks
// only three KV tiles, so its chain (S, softmax, P V in turn) and epilogue
// are exposed.  The smaller levels are latency: a CTA's chain of 3-5 KV
// tiles and its prologue; with 8-column slabs their time followed the TMA
// row requests of the tiles, which the wide atoms cut two to five times.
#include <math_constants.h>

#include <algorithm>

#include "common.cuh"
#include "flash_attention_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BLOCK_M = 64;   // q rows per CTA (fp32 path)
constexpr int BLOCK_N = 64;   // KV rows per tile (fp32 path)
constexpr int THREADS = 128;

// ------------------------------------------------------------ fp32 path
constexpr int F_ROWS = 4;                 // q rows per thread: rg + 16 * i
constexpr int F_COLS = 8;                 // score columns per thread: cg + 8 * j
constexpr int F_P_STRIDE = BLOCK_N + 8;   // conflict-free P writes/reads

// Q and K rows are QK floats apart: an odd number of 16-byte chunks, so the 8
// K rows a warp reads at one column fall in 8 distinct banks.
template <int DH>
struct F32Layout {
  static_assert(DH % 8 == 0, "head dim must be a multiple of 8");
  static constexpr int QK = (DH / 4) % 2 == 1 ? DH : DH + 4;
  static constexpr int Q_ELEMS = BLOCK_M * QK;
  static constexpr int K_ELEMS = BLOCK_N * QK;  // one stage
  static constexpr int V_ELEMS = BLOCK_N * DH;  // one stage
  static constexpr size_t TILE_BYTES =
      sizeof(float) * (size_t)(Q_ELEMS + 2 * K_ELEMS + 2 * V_ELEMS);
  static constexpr size_t SMEM = TILE_BYTES + sizeof(float) * BLOCK_M * F_P_STRIDE;
};

template <int DH>
__global__ void __launch_bounds__(THREADS)
onepass_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, Strides st, int sq,
                   int sk, int causal, float scale_log2) {
  using L = F32Layout<DH>;
  constexpr int QK = L::QK;
  constexpr int DCOLS = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + L::Q_ELEMS;      // two stages
  float* Vs = Ks + 2 * L::K_ELEMS;  // two stages
  float* Ps = reinterpret_cast<float*>(smem_raw + L::TILE_BYTES);

  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const long long h = blockIdx.y;
  const long long b = blockIdx.z;
  const int q0 = blockIdx.x * BLOCK_M;
  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h;

  load_tile<float, DH, QK, BLOCK_M, THREADS>(Qs, qb, st.q_r, q0, sq, tid);
  load_tile<float, DH, QK, BLOCK_N, THREADS>(Ks, kb, st.k_r, 0, sk, tid);
  load_tile<float, DH, DH, BLOCK_N, THREADS>(Vs, vb, st.v_r, 0, sk, tid);
  cp_async_commit();

  int n_tiles = (sk + BLOCK_N - 1) / BLOCK_N;
  if (causal) {
    const int last_row = min(q0 + BLOCK_M, sq) - 1;
    n_tiles = min(n_tiles, last_row / BLOCK_N + 1);
  }

  float m[F_ROWS], l[F_ROWS], acc[F_ROWS][DCOLS];
#pragma unroll
  for (int i = 0; i < F_ROWS; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int dc = 0; dc < DCOLS; ++dc) acc[i][dc] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    const int kv0 = t * BLOCK_N;
    if (t + 1 < n_tiles) {
      const int next = kv0 + BLOCK_N;
      load_tile<float, DH, QK, BLOCK_N, THREADS>(Ks + (stage ^ 1) * L::K_ELEMS, kb, st.k_r,
                                                 next, sk, tid);
      load_tile<float, DH, DH, BLOCK_N, THREADS>(Vs + (stage ^ 1) * L::V_ELEMS, vb, st.v_r,
                                                 next, sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Kt = Ks + stage * L::K_ELEMS;
    const float* Vt = Vs + stage * L::V_ELEMS;

    float s[F_ROWS][F_COLS];
#pragma unroll
    for (int i = 0; i < F_ROWS; ++i)
#pragma unroll
      for (int j = 0; j < F_COLS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[F_ROWS], kv[F_COLS];
#pragma unroll
      for (int i = 0; i < F_ROWS; ++i) qv[i] = Qs[(rg + 16 * i) * QK + d];
#pragma unroll
      for (int j = 0; j < F_COLS; ++j) kv[j] = Kt[(cg + 8 * j) * QK + d];
#pragma unroll
      for (int i = 0; i < F_ROWS; ++i)
#pragma unroll
        for (int j = 0; j < F_COLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < F_ROWS; ++i) {
      const int row = q0 + rg + 16 * i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < F_COLS; ++j) {
        const int col = kv0 + cg + 8 * j;
        const bool ok = col < sk && (!causal || col <= row);
        s[i][j] = ok ? s[i][j] * scale_log2 : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;  // fully masked guard
      const float alpha = exp2f(m[i] - m_use);
      float rs = 0.f;
      float* prow = Ps + (rg + 16 * i) * F_P_STRIDE;
#pragma unroll
      for (int j = 0; j < F_COLS; ++j) {
        const float p = exp2f(s[i][j] - m_use);
        rs += p;
        prow[cg + 8 * j] = p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int dc = 0; dc < DCOLS; ++dc) acc[i][dc] *= alpha;
    }
    __syncthreads();

    const int n_valid = min(BLOCK_N, sk - kv0);
    for (int cc = 0; cc < n_valid; ++cc) {
      float pv[F_ROWS];
#pragma unroll
      for (int i = 0; i < F_ROWS; ++i) pv[i] = Ps[(rg + 16 * i) * F_P_STRIDE + cc];
#pragma unroll
      for (int dc = 0; dc < DCOLS; ++dc) {
        const float vv = Vt[cc * DH + cg + 8 * dc];
#pragma unroll
        for (int i = 0; i < F_ROWS; ++i) acc[i][dc] = fmaf(pv[i], vv, acc[i][dc]);
      }
    }
    __syncthreads();  // this stage's K/V and P are read before they are refilled
  }

#pragma unroll
  for (int i = 0; i < F_ROWS; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = o + b * st.o_b + h * st.o_h + (long long)row * st.o_r;
#pragma unroll
    for (int dc = 0; dc < DCOLS; ++dc) orow[cg + 8 * dc] = acc[i][dc] * inv;
  }
}

// ------------------------------------------------------------ launch
// The swizzle atom of each head dim (columns; see Cfg): as wide as keeps a
// 308-token KV resident at 128 q rows a CTA, so that a tile's rows take
// one to five TMA boxes instead of two to twenty
__host__ __device__ constexpr int atom_of(int dh) { return dh == 16 ? 16 : dh == 80 || dh == 160 ? 32 : 64; }

// K2's bf16 kernel: the template's body in its ONEPASS form
template <int DH, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
onepass_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                  long long o_b, long long o_h, long long o_r, int sq, int sk,
                  float scale_log2, int causal) {
  sdt_tc::attention_tc_body<DH, NWG, true, atom_of(DH)>(&tm_q, &tm_k, &tm_v, o, o_b, o_h, o_r,
                                                        sq, sk, scale_log2, causal != 0);
}

template <int DH, int NWG>
using TcCfg = sdt_tc::Cfg<DH, NWG, 2, atom_of(DH)>;

// A schedule: consumer warpgroups a CTA, CTAs a (head, batch) (each takes q
// tiles x, x + ctas, ...), the ring's stages and the shared memory
struct Plan {
  int nwg, ctas, stages, smem;
};

template <int DH, int NWG>
Plan plan_of(int ctas) {
  return {NWG, ctas, TcCfg<DH, NWG>::STAGES, TcCfg<DH, NWG>::SMEM};
}

// The schedule of a bf16 call on `sms` SMs (the file header says why):
//   * small grid: every 64-row q tile on an SM of its own, in one wave;
//   * else CTAs of 128 or 192 rows (192 only where the ring keeps three
//     stages): resident where the KV tiles the call walks fit in the ring
//     (as many CTAs a (head, batch) as keep the CTAs within one wave, the q
//     tiles dealt out among them), streamed otherwise (a q tile a CTA); of
//     the two widths, the one whose busiest SM walks fewer 64-row q blocks,
//     waves counted, and 192 rows on a tie (each K/V tile then serves more
//     rows).
template <int DH>
Plan plan(int batch, int n_heads, int sq, int sk, bool causal, int sms) {
  const long long bh = (long long)batch * n_heads;
  if ((sq + 63) / 64 * bh <= sms) return plan_of<DH, 1>((sq + 63) / 64);
  constexpr int BN = TcCfg<DH, 2>::BLOCK_N;
  const int n_tiles = (sk + BN - 1) / BN;
  const int walked = causal ? std::min(n_tiles, (sq - 1) / BN + 1) : n_tiles;
  auto ctas_and_cost = [&](int nwg, int stages, int& ctas) {
    const int n_q = (sq + 64 * nwg - 1) / (64 * nwg);
    ctas = walked <= stages ? (int)std::max(1LL, std::min((long long)n_q, sms / bh)) : n_q;
    return (n_q + ctas - 1) / ctas * ((ctas * bh + sms - 1) / sms) * nwg;
  };
  int c2 = 0, c3 = 0;
  const long long cost2 = ctas_and_cost(2, TcCfg<DH, 2>::STAGES, c2);
  if (TcCfg<DH, 3>::STAGES >= 3 && ctas_and_cost(3, TcCfg<DH, 3>::STAGES, c3) <= cost2)
    return plan_of<DH, 3>(c3);
  return plan_of<DH, 2>(c2);
}

template <int DH, int NWG>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, const Strides& st,
                      int batch, int n_heads, int sq, int sk, int causal, int ctas,
                      cudaStream_t stream) {
  using C = TcCfg<DH, NWG>;
  constexpr CUtensorMapSwizzle sw = C::COLS == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : C::COLS == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tq, tk, tv;
  if (!sdt_tc::make_map(&tq, q, DH, n_heads, sq, batch, st.q_h, st.q_r, st.q_b, C::BLOCK_M,
                        C::COLS, sw) ||
      !sdt_tc::make_map(&tk, k, DH, n_heads, sk, batch, st.k_h, st.k_r, st.k_b, C::BLOCK_N,
                        C::COLS, sw) ||
      !sdt_tc::make_map(&tv, v, DH, n_heads, sk, batch, st.v_h, st.v_r, st.v_b, C::BLOCK_N,
                        C::COLS, sw))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      onepass_tc_kernel<DH, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(ctas, n_heads, batch);
  const float scale_log2 = LOG2E / sqrtf((float)DH);
  onepass_tc_kernel<DH, NWG><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), st.o_b, st.o_h, st.o_r, sq, sk, scale_log2, causal);
  return cudaGetLastError();
}

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  return err == cudaSuccess
             ? cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device)
             : err;
}

template <int DH>
cudaError_t launch_bf16(const Plan& p, const void* q, const void* k, const void* v, void* o,
                        const Strides& st, int batch, int n_heads, int sq, int sk, int causal,
                        cudaStream_t stream) {
  switch (p.nwg) {
    case 1: return launch_tc<DH, 1>(q, k, v, o, st, batch, n_heads, sq, sk, causal, p.ctas, stream);
    case 2: return launch_tc<DH, 2>(q, k, v, o, st, batch, n_heads, sq, sk, causal, p.ctas, stream);
    default:
      if constexpr (TcCfg<DH, 3>::STAGES >= 3)
        return launch_tc<DH, 3>(q, k, v, o, st, batch, n_heads, sq, sk, causal, p.ctas, stream);
      return cudaErrorInvalidValue;
  }
}

template <int DH>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o,
                   const Strides& st, int batch, int n_heads, int sq, int sk, int causal,
                   cudaStream_t stream) {
  if (dtype == 1) {
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    const Plan p = plan<DH>(batch, n_heads, sq, sk, causal != 0, sms);
    return launch_bf16<DH>(p, q, k, v, o, st, batch, n_heads, sq, sk, causal, stream);
  }
  const dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, n_heads, batch);
  const float scale_log2 = LOG2E / sqrtf((float)DH);
  const size_t smem = F32Layout<DH>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(onepass_f32_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  onepass_f32_kernel<DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st, sq, sk, causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 12 values in elements, (batch, head, row) for q, k, v, o in that
// order; the head-dim stride is 1.  dtype: 0 = float32 (CUDA cores), 1 =
// bfloat16 (tensor cores); head_dim: 16, 40, 64, 80, 128 or 160; causal: 0
// or 1.  Returns the cudaError_t of the launch (0 on success); never
// synchronizes.
int sdt_flash_attention_onepass(const void* q, const void* k, const void* v, void* o,
                                const long long* strides, int batch, int n_heads, int sq,
                                int sk, int head_dim, int dtype, int causal, void* stream) {
  if (batch <= 0 || sq <= 0 || n_heads <= 0) return cudaSuccess;
  if (sk <= 0 || n_heads > 65535 || batch > 65535) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],  strides[5],
                   strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(dtype, q, k, v, o, st, batch, n_heads, sq, sk, causal, s);
    case 40: return launch<40>(dtype, q, k, v, o, st, batch, n_heads, sq, sk, causal, s);
    case 64: return launch<64>(dtype, q, k, v, o, st, batch, n_heads, sq, sk, causal, s);
    case 80: return launch<80>(dtype, q, k, v, o, st, batch, n_heads, sq, sk, causal, s);
    case 128: return launch<128>(dtype, q, k, v, o, st, batch, n_heads, sq, sk, causal, s);
    case 160: return launch<160>(dtype, q, k, v, o, st, batch, n_heads, sq, sk, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

// The schedule the bf16 path takes for a call on this device: consumer
// warpgroups a CTA, CTAs a (head, batch), ring stages, shared memory bytes
// (out[0..3]).  Returns a cudaError_t (0 on success).
int sdt_flash_attention_onepass_config(int batch, int n_heads, int sq, int sk, int head_dim,
                                       int causal, int* out) {
  if (batch <= 0 || sq <= 0 || n_heads <= 0 || sk <= 0) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  Plan p{};
  switch (head_dim) {
#define SDT_PLAN(D) \
  case D: p = plan<D>(batch, n_heads, sq, sk, causal != 0, sms); break;
    SDT_PLAN(16) SDT_PLAN(40) SDT_PLAN(64) SDT_PLAN(80) SDT_PLAN(128) SDT_PLAN(160)
#undef SDT_PLAN
    default: return cudaErrorInvalidValue;
  }
  out[0] = p.nwg;
  out[1] = p.ctas;
  out[2] = p.stages;
  out[3] = p.smem;
  return cudaSuccess;
}

}  // extern "C"
