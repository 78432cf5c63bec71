// K4: streamed flash attention over a long KV, head-split (B, H, S, Dh), for Hopper.
//
// Replaces the Pallas kernel
//   pytorch_stable_diffusion_tpu/ops/pallas/flash_attention.py::_flash_attention_streamed
//   (:466 -> pallas_call :484 -> body _streamed_kernel :202).
// It computes what that kernel computes, non-causal softmax(Q K^T / sqrt(Dh)) V
// for every (batch, head) with Dh <= 128:
//   * scores and softmax in fp32; 1/sqrt(Dh) folded with log2(e) into exp2;
//   * an online softmax over KV tiles (running max m, sum l, accumulator);
//   * the KV tail of the last tile masked to -inf, with a guard for fully
//     masked rows (exp2 of (-inf) - (-inf) would be NaN);
//   * output acc / max(l, 1e-30) written in the input dtype (bf16 or fp32).
//
// What the TPU kernel is for, and what is kept of it.  Its point is to walk a
// very long KV inside one grid cell while the next KV slab is already in
// flight.  Its transposed (BH, Dh, Sk) KV and its 4096-token groups exist only
// because TPU DMA slices need 128 lanes, and are not carried over.  Here a CTA
// owns a block of q rows of one (head, batch) and walks the whole KV in tiles
// through a ring in shared memory, the next tiles' copies in flight while the
// current one computes.
//
// Strides.  q, k, v and the output are taken with their own batch, head and
// row strides (in elements, 64-bit) and a unit head-dim stride: the UNet
// passes its fused q/k/v projection viewed as (B, H, S, Dh) without a copy,
// and the wrapper's output is (B, S, H, Dh) memory, so merging the heads
// afterwards is free.  Every offset is computed in 64 bits: at 262144 tokens
// a row index times a row stride of 3C overflows an int.
//
// bf16 path: the tensor-core template of flash_attention_tc.cuh (wgmma for
// Q K^T and P V, K/V tiles by TMA into an mbarrier ring, a producer
// warpgroup and three consumer warpgroups of 64 q rows that take turns on
// the tensor cores).  Needs 16-byte aligned pointers and strides (the
// wrapper checks).
//
// What bounds it on the H100.  At SD-1.5's 2048² level 1, (2, 8, 65536, 40),
// a call costs 4*Sq*Sk*Dh*B*H = 11 TFLOP (11.1 ms at 989 TFLOP/s) and must
// move 0.34 GB in bf16 (0.1 ms), and needs B*H*Sq*Sk = 68.7 G exp2: at 16 a
// clock per SM on 132 SMs (~4.2 T/s at 1.98 GHz) ~16-18 ms.  On paper the
// exponential, not the tensor cores, sets the floor; flash_attention_tc.cuh
// says what the design does about it, and what the card showed instead: the
// K/V stream from L2 (each of a head's 342 q tiles reads its 65536-token K
// and V) holds it back.
//
// fp32 path (the FP32 policy's checks need full fp32: no TF32): one CTA of
// 128 threads per (64-row q tile, head, batch) on the CUDA cores, KV in 64-row
// tiles through a two-stage cp.async ring (rows past Sk zero-filled by the
// copy).  Thread (rg, cg), rg = tid / 8, cg = tid % 8, owns q rows rg + 16*i
// (i < 4) and, for the scores, KV columns cg + 8*j (j < 8); row max and sum
// reduce over the 8 lanes of a row group with warp shuffles; P goes through
// shared memory and the same thread accumulates P V for its 4 rows over
// head-dim columns cg + 8*k.
#include <math_constants.h>

#include "common.cuh"
#include "flash_attention_tc.cuh"

namespace {

constexpr int BLOCK_M = 64;   // q rows per CTA
constexpr int BLOCK_N = 64;   // KV rows per tile
constexpr int THREADS = 128;  // 16 row groups x 8 column groups
constexpr int ROWS = 4;       // q rows per thread: rg + 16 * i
constexpr int COLS = 8;       // score columns per thread: cg + 8 * j
constexpr int P_STRIDE = BLOCK_N + 8;  // conflict-free P writes/reads

// Shared-memory layout.  Q and K rows are QK elements apart: a multiple of 16
// bytes (cp.async writes 16-byte chunks) that is an odd number of chunks, so
// the 8 K rows a warp reads at one column fall in 8 distinct banks.
template <int DH>
struct Layout {
  using T = float;
  static_assert(DH % 8 == 0, "head dim must be a multiple of 8");
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int QK = (DH / VEC) % 2 == 1 ? DH : DH + VEC;
  static constexpr int Q_ELEMS = BLOCK_M * QK;
  static constexpr int K_ELEMS = BLOCK_N * QK;  // one stage
  static constexpr int V_ELEMS = BLOCK_N * DH;  // one stage
  static constexpr size_t TILE_BYTES = sizeof(T) * (size_t)(Q_ELEMS + 2 * K_ELEMS + 2 * V_ELEMS);
  static constexpr size_t SMEM = TILE_BYTES + sizeof(float) * BLOCK_M * P_STRIDE;
};

template <int DH>
__global__ void __launch_bounds__(THREADS)
streamed_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, Strides st, int sq,
                     int sk, float scale_log2) {
  using T = float;
  using L = Layout<DH>;
  constexpr int QK = L::QK;
  constexpr int DCOLS = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + L::Q_ELEMS;      // two stages
  T* Vs = Ks + 2 * L::K_ELEMS;  // two stages
  float* Ps = reinterpret_cast<float*>(smem_raw + L::TILE_BYTES);

  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const long long h = blockIdx.y;
  const long long b = blockIdx.z;
  const int q0 = blockIdx.x * BLOCK_M;
  const T* qb = q + b * st.q_b + h * st.q_h;
  const T* kb = k + b * st.k_b + h * st.k_h;
  const T* vb = v + b * st.v_b + h * st.v_h;

  // group 0: the Q tile and KV tile 0
  load_tile<T, DH, QK, BLOCK_M, THREADS>(Qs, qb, st.q_r, q0, sq, tid);
  load_tile<T, DH, QK, BLOCK_N, THREADS>(Ks, kb, st.k_r, 0, sk, tid);
  load_tile<T, DH, DH, BLOCK_N, THREADS>(Vs, vb, st.v_r, 0, sk, tid);
  cp_async_commit();

  float m[ROWS], l[ROWS], acc[ROWS][DCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int dc = 0; dc < DCOLS; ++dc) acc[i][dc] = 0.f;
  }

  const int n_tiles = (sk + BLOCK_N - 1) / BLOCK_N;
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    const int kv0 = t * BLOCK_N;
    if (t + 1 < n_tiles) {  // prefetch tile t+1 into the other stage
      const int next = kv0 + BLOCK_N;
      load_tile<T, DH, QK, BLOCK_N, THREADS>(Ks + (stage ^ 1) * L::K_ELEMS, kb, st.k_r, next,
                                             sk, tid);
      load_tile<T, DH, DH, BLOCK_N, THREADS>(Vs + (stage ^ 1) * L::V_ELEMS, vb, st.v_r, next,
                                             sk, tid);
    }
    // always commit (an empty group on the last tile), so that "all but the
    // newest group" is exactly "everything up to tile t"
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Kt = Ks + stage * L::K_ELEMS;
    const T* Vt = Vs + stage * L::V_ELEMS;

    // S = Q K^T for this thread's 4x8 tile
    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = to_f32(Qs[(rg + 16 * i) * QK + d]);
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = to_f32(Kt[(cg + 8 * j) * QK + d]);
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax: scale, mask the KV tail, merge with the running stats
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int col = kv0 + cg + 8 * j;
        s[i][j] = col < sk ? s[i][j] * scale_log2 : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;  // fully masked guard
      const float alpha = exp2f(m[i] - m_use);
      float rs = 0.f;
      float* prow = Ps + (rg + 16 * i) * P_STRIDE;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
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

    // acc += P V over this tile's valid rows
    const int n_valid = min(BLOCK_N, sk - kv0);
    for (int cc = 0; cc < n_valid; ++cc) {
      float pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = Ps[(rg + 16 * i) * P_STRIDE + cc];
#pragma unroll
      for (int dc = 0; dc < DCOLS; ++dc) {
        const float vv = to_f32(Vt[cc * DH + cg + 8 * dc]);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][dc] = fmaf(pv[i], vv, acc[i][dc]);
      }
    }
    __syncthreads();  // this stage's K/V and P are read before they are refilled
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + b * st.o_b + h * st.o_h + (long long)row * st.o_r;
#pragma unroll
    for (int dc = 0; dc < DCOLS; ++dc) orow[cg + 8 * dc] = from_f32<T>(acc[i][dc] * inv);
  }
}

template <int DH>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o,
                        const Strides& st, int batch, int n_heads, int sq, int sk,
                        cudaStream_t stream) {
  const size_t smem = Layout<DH>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(streamed_fp32_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, n_heads, batch);
  const float scale_log2 = LOG2E / sqrtf((float)DH);
  streamed_fp32_kernel<DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st, sq, sk, scale_log2);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o,
                   const Strides& st, int batch, int n_heads, int sq, int sk,
                   cudaStream_t stream) {
  return dtype == 0 ? launch_fp32<DH>(q, k, v, o, st, batch, n_heads, sq, sk, stream)
                    : sdt_tc::launch<DH>(q, k, v, o, st, batch, n_heads, sq, sk, stream);
}

cudaError_t dispatch_dh(int dtype, int head_dim, const void* q, const void* k, const void* v,
                        void* o, const Strides& st, int batch, int n_heads, int sq, int sk,
                        cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<16>(dtype, q, k, v, o, st, batch, n_heads, sq, sk, stream);
    case 40: return launch<40>(dtype, q, k, v, o, st, batch, n_heads, sq, sk, stream);
    case 64: return launch<64>(dtype, q, k, v, o, st, batch, n_heads, sq, sk, stream);
    case 128: return launch<128>(dtype, q, k, v, o, st, batch, n_heads, sq, sk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// strides: 12 values in elements, (batch, head, row) for q, k, v, o in that
// order; the head-dim stride is 1.  dtype: 0 = float32, 1 = bfloat16.  Returns
// the cudaError_t of the launch (0 on success); never synchronizes.
int sdt_flash_attention_streamed(const void* q, const void* k, const void* v, void* o,
                                 const long long* strides, int batch, int n_heads, int sq,
                                 int sk, int head_dim, int dtype, void* stream) {
  if (batch <= 0 || sq <= 0 || n_heads <= 0) return cudaSuccess;
  if (sk <= 0 || n_heads > 65535 || batch > 65535) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],  strides[5],
                   strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  return dispatch_dh(dtype, head_dim, q, k, v, o, st, batch, n_heads, sq, sk,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
