// K2: one-pass flash attention, head-split (B, H, S, Dh), causal or not, for Hopper.
//
// Replaces the Pallas kernel
//   pytorch_stable_diffusion_tpu/ops/pallas/flash_attention.py::flash_attention
//   (its one-pass call, :587; body: _onepass_kernel :179, with the chunk
//   statistics of _chunk_softmax_stats :75).
// It computes what that kernel computes, softmax(Q K^T / sqrt(Dh)) V for every
// (batch, head), over a KV of up to 9216 tokens (the router's bound; the
// kernel itself takes any length):
//   * scores and softmax in fp32; 1/sqrt(Dh) folded with log2(e) and exp2f,
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
// merged in closed form so that the MXU overlaps the VPU's exp.  Here a CTA
// has at most 227 KB of shared memory and the chunk merge buys nothing, so
// the KV is walked with an online softmax (the same merge, one tile at a
// time): one CTA of 128 threads owns a (64-row q tile, head, batch), K/V
// tiles of 64 tokens come through a two-stage cp.async ring (tile j+1 in
// flight while tile j computes; rows past Sk zero-filled by the copy), and
// the running max m, sum l and accumulator stay in registers.  Causal: KV
// tiles wholly above the diagonal are skipped.
//
// bf16 path: the tensor cores through mma.sync m16n8k16 (bf16 in, fp32
// accumulate), each of the four warps owning 16 q rows:
//   * S = Q K^T: Q and K fragments by ldmatrix from shared memory; Dh is
//     zero-padded in shared memory to a multiple of 16 (40 -> 48; 16, 64,
//     80, 128 and 160 already are), the pad columns zeroed once;
//   * the score accumulators of two n8 tiles are exactly the A fragment of
//     a k16 step of P V, so P never leaves the registers;
//   * V fragments by ldmatrix.trans (V is (token, Dh) row-major);
//   * shared rows are Dh_pad + 8 elements apart, an odd number of 16-byte
//     units, so the 8 rows an ldmatrix phase reads fall in distinct banks.
// fp32 path (the FP32 policy's checks): K4's CUDA-core design
// (csrc/flash_attention_streamed.cu) with the causal mask: thread (rg, cg)
// owns q rows rg + 16*i and score columns cg + 8*j, P goes through shared
// memory; no TF32.
//
// Strides.  q, k, v and the output are taken with their own batch, head and
// row strides (elements, 64-bit offsets) and a unit head-dim stride: the
// UNet passes its q projection and its fused k/v projection of the context
// (rows 2C apart) viewed as (B, H, S, Dh) without a copy, and the wrapper's
// output is (B, S, H, Dh) memory, so merging the heads is free.
//
// What bounds it on the H100.  SD-1.5's level-1 cross-attention under a
// 4-window prompt, (2, 8, 4096, 40) x KV 308, costs 4*Sq*Sk*Dh*B*H = 3.2
// GFLOP (3.3 us at 989 TFLOP/s) and must move ~11 MB in bf16 (q and out
// 10.5 MB, k and v 0.4 MB; 3.4 us at 3.35 TB/s): memory-bound, by a hair.
// Left on the table: wgmma fed by TMA, Q held in registers, a deeper ring;
// at this shape K/V are re-read from L2 by each of the 64 q tiles.
#include <math_constants.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BLOCK_M = 64;   // q rows per CTA
constexpr int BLOCK_N = 64;   // KV rows per tile
constexpr int THREADS = 128;

// ------------------------------------------------------------ bf16 path
template <int DH>
struct Bf16Layout {
  static constexpr int DHP = (DH + 15) / 16 * 16;  // Dh padded to the MMA depth
  static constexpr int LD = DHP + 8;               // shared row stride (elements)
  static constexpr int TILE = BLOCK_M * LD;        // one 64-row tile (BLOCK_M == BLOCK_N)
  static constexpr size_t SMEM = sizeof(bf16) * 5 * (size_t)TILE;  // Q + 2 x (K, V)
  static_assert((LD * sizeof(bf16) / 16) % 2 == 1, "rows must be an odd number of 16 B units");
};

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
onepass_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, Strides st, int sq,
                    int sk, int causal, float scale_log2) {
  using L = Bf16Layout<DH>;
  constexpr int DHP = L::DHP;
  constexpr int LD = L::LD;
  constexpr int KSTEPS = DHP / 16;  // k16 steps of Q K^T
  constexpr int NT = DHP / 8;       // n8 tiles of the output
  constexpr int ST = BLOCK_N / 8;   // n8 tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + L::TILE;      // two stages
  bf16* Vs = Ks + 2 * L::TILE;  // two stages

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long h = blockIdx.y;
  const long long b = blockIdx.z;
  const int q0 = blockIdx.x * BLOCK_M;
  const bf16* qb = q + b * st.q_b + h * st.q_h;
  const bf16* kb = k + b * st.k_b + h * st.k_h;
  const bf16* vb = v + b * st.v_b + h * st.v_h;

  // the pad columns DH..DHP-1 of all five tiles: the copies never write them
  if constexpr (DHP > DH) {
    constexpr int PAD = DHP - DH;
    for (int i = tid; i < 5 * BLOCK_M * PAD; i += THREADS)
      Qs[(i / PAD) * LD + DH + i % PAD] = __float2bfloat16(0.f);
  }

  // group 0: the Q tile and KV tile 0
  load_tile<bf16, DH, LD, BLOCK_M, THREADS>(Qs, qb, st.q_r, q0, sq, tid);
  load_tile<bf16, DH, LD, BLOCK_N, THREADS>(Ks, kb, st.k_r, 0, sk, tid);
  load_tile<bf16, DH, LD, BLOCK_N, THREADS>(Vs, vb, st.v_r, 0, sk, tid);
  cp_async_commit();

  int n_tiles = (sk + BLOCK_N - 1) / BLOCK_N;
  if (causal) {  // skip the tiles wholly above the diagonal
    const int last_row = min(q0 + BLOCK_M, sq) - 1;
    n_tiles = min(n_tiles, last_row / BLOCK_N + 1);
  }

  // this lane's rows: r0 + 8 * half of the warp's 16; columns 2 * (lane % 4)
  // and +1 of each n8 tile
  const int wr = warp * 16;
  const int r0 = lane >> 2, c0 = (lane & 3) * 2;
  // ldmatrix row addresses: A (Q) rows wr + (lane & 15), k half lane >> 4;
  // B (K) token (lane & 7) + 8 * (lane >> 4), k half (lane >> 3) & 1;
  // B (V, transposed) token (lane & 7) + 8 * ((lane >> 3) & 1), d half lane >> 4
  const bf16* qa = Qs + (wr + (lane & 15)) * LD + (lane >> 4) * 8;
  const int kb_off = ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const int vb_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    const int kv0 = t * BLOCK_N;
    if (t + 1 < n_tiles) {  // prefetch tile t+1 into the other stage
      load_tile<bf16, DH, LD, BLOCK_N, THREADS>(Ks + (stage ^ 1) * L::TILE, kb, st.k_r,
                                                kv0 + BLOCK_N, sk, tid);
      load_tile<bf16, DH, LD, BLOCK_N, THREADS>(Vs + (stage ^ 1) * L::TILE, vb, st.v_r,
                                                kv0 + BLOCK_N, sk, tid);
    }
    // always commit (an empty group on the last tile), so that "all but the
    // newest group" is exactly "everything up to tile t"
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + stage * L::TILE;
    const bf16* Vt = Vs + stage * L::TILE;

    // S = Q K^T: 16 rows x 64 columns a warp
    float s[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, qa + kk * 16);
#pragma unroll
      for (int nj = 0; nj < ST / 2; ++nj) {
        unsigned bm[4];
        ldmatrix_x4(bm, Kt + nj * 16 * LD + kb_off + kk * 16);
        mma_bf16(s[2 * nj], a, bm[0], bm[1]);
        mma_bf16(s[2 * nj + 1], a, bm[2], bm[3]);
      }
    }

    // online softmax: scale, mask, merge with the running stats; the four
    // lanes of a quad share a row
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + wr + r0 + 8 * half;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kv0 + j * 8 + c0 + e;
          const bool ok = col < sk && (!causal || col <= row);
          const float x = ok ? s[j][2 * half + e] * scale_log2 : -CUDART_INF_F;
          s[j][2 * half + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], mx);
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;  // fully masked guard
      const float alpha = exp2f(m[half] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[j][2 * half + e] - m_use);
          s[j][2 * half + e] = p;
          rs += p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[half] = l[half] * alpha + rs;
      m[half] = m_new;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[nt][2 * half] *= alpha;
        acc[nt][2 * half + 1] *= alpha;
      }
    }

    // acc += P V: the scores of n8 tiles 2j and 2j+1 are the A fragment of
    // the j-th k16 step (rows r0 / r0 + 8, columns c0 / c0 + 8)
#pragma unroll
    for (int j = 0; j < ST / 2; ++j) {
      const unsigned pa[4] = {pack_bf16x2(s[2 * j][0], s[2 * j][1]),
                              pack_bf16x2(s[2 * j][2], s[2 * j][3]),
                              pack_bf16x2(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16x2(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, Vt + j * 16 * LD + vb_off + np * 16);
        mma_bf16(acc[2 * np], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage's K/V are read before they are refilled
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + wr + r0 + 8 * half;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[half], 1e-30f);
    bf16* orow = o + b * st.o_b + h * st.o_h + (long long)row * st.o_r;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + c0;
      if (col < DH)  // DH is a multiple of 8: col and col + 1 are both in or out
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[nt][2 * half] * inv, acc[nt][2 * half + 1] * inv);
    }
  }
}

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
template <int DH>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o,
                   const Strides& st, int batch, int n_heads, int sq, int sk, int causal,
                   cudaStream_t stream) {
  const dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, n_heads, batch);
  const float scale_log2 = LOG2E / sqrtf((float)DH);
  if (dtype == 1) {
    const size_t smem = Bf16Layout<DH>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(onepass_bf16_kernel<DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    onepass_bf16_kernel<DH><<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), st, sq, sk, causal, scale_log2);
    return cudaGetLastError();
  }
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

}  // extern "C"