// K1: flash attention on heads packed in channels, (B, S, H*Dh), for Hopper.
//
// Replaces the Pallas kernel
//   pytorch_stable_diffusion_tpu/ops/pallas/flash_attention.py::flash_attention_bsc
//   (:384 -> pallas_call :412 -> body _bsc_kernel :300).
// It computes what that kernel computes, non-causal softmax(Q K^T / sqrt(Dh)) V
// for every (batch, head), with the heads sliced out of the channel axis so
// the caller needs no head transposes:
//   * scores and softmax in fp32; 1/sqrt(Dh) folded with log2(e) into exp2;
//   * an online softmax over KV tiles (running max m, sum l, accumulator);
//   * the KV tail of the last tile masked to -inf, with a guard for fully
//     masked rows (exp2 of (-inf) - (-inf) would be NaN);
//   * output acc / max(l, 1e-30) written in the input dtype (bf16 or fp32).
//
// Strides.  q, k and v are taken with their own batch and row strides (in
// elements) and a unit channel stride: the model passes the three C-wide
// slices of the fused q/k/v projection, whose rows are 3C apart, without a
// copy.  The output is a contiguous (B, Sq, C) tensor.
//
// bf16 path: the tensor-core template of flash_attention_tc.cuh, with the
// head stride Dh: wgmma for Q K^T and P V, K/V tiles by TMA (one 16-byte-wide
// box per 8-column slab of a (Dh, head, row, batch) map, so Dh is its own
// dimension and a box never reaches into the next head) into an mbarrier
// ring, a producer warpgroup and three consumer warpgroups of 64 q rows that
// take turns on the tensor cores.  Needs 16-byte aligned pointers and row
// strides (the wrapper checks; the UNet's views are: rows 3C x 2 bytes apart,
// heads Dh x 2).
//
// What bounds it on the H100.  At the main shape (2, 4096, 320), 8 heads of
// Dh 40, a call costs 4*S^2*C*B = 43 GFLOP (0.043 ms at 989 TFLOP/s) but moves
// only ~21 MB (0.006 ms), and needs B*H*S^2 = 268 M exp2 (~0.064 ms at 16 a
// clock per SM on 132 SMs): on paper the exponential sets the floor, then the
// tensor cores.  flash_attention_tc.cuh says what the design does about it,
// and what the card showed instead: the K/V stream from L2 into shared
// memory holds it back.
//
// fp32 path (the FP32 policy's checks need full fp32: no TF32): one CTA of
// 128 threads per (64-row q tile, head, batch) on the CUDA cores.  Thread
// (rg, cg), rg = tid / 8, cg = tid % 8, owns q rows rg + 16*i (i < 4) and, for
// the scores, KV columns cg + 8*j (j < 8); row max and sum reduce over the 8
// lanes of a row group with warp shuffles; P goes through shared memory and
// the same thread accumulates P V over head-dim columns cg + 8*k.
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

template <int DH>
struct Smem {
  static constexpr int QK_STRIDE = DH + 1;  // odd row stride: rows hit distinct banks
};

template <int DH>
size_t smem_bytes() {
  using T = float;
  constexpr int QK = Smem<DH>::QK_STRIDE;
  size_t tiles = sizeof(T) * (size_t)(BLOCK_M * QK + BLOCK_N * QK + BLOCK_N * DH);
  tiles = (tiles + 15) / 16 * 16;
  return tiles + sizeof(float) * BLOCK_M * P_STRIDE;
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
bsc_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, long long q_bs,
                long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                long long v_rs, int sq, int sk, int c, float scale_log2) {
  using T = float;
  static_assert(DH % 8 == 0, "head dim must be a multiple of 8");
  constexpr int QK = Smem<DH>::QK_STRIDE;
  constexpr int DCOLS = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BLOCK_M * QK;
  T* Vs = Ks + BLOCK_N * QK;
  size_t tile_bytes = sizeof(T) * (size_t)(BLOCK_M * QK + BLOCK_N * QK + BLOCK_N * DH);
  float* Ps = reinterpret_cast<float*>(smem_raw + (tile_bytes + 15) / 16 * 16);

  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BLOCK_M;
  const T* qb = q + b * q_bs + (long long)h * DH;
  const T* kb = k + b * k_bs + (long long)h * DH;
  const T* vb = v + b * v_bs + (long long)h * DH;
  const T zero = from_f32<T>(0.f);

  for (int e = tid; e < BLOCK_M * DH; e += THREADS) {
    const int r = e / DH, d = e - r * DH;
    const int row = q0 + r;
    Qs[r * QK + d] = row < sq ? qb[row * q_rs + d] : zero;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int dc = 0; dc < DCOLS; ++dc) acc[i][dc] = 0.f;
  }

  for (int kv0 = 0; kv0 < sk; kv0 += BLOCK_N) {
    __syncthreads();  // the previous tile's K/V/P reads are done
    for (int e = tid; e < BLOCK_N * DH; e += THREADS) {
      const int r = e / DH, d = e - r * DH;
      const int row = kv0 + r;
      const bool ok = row < sk;
      Ks[r * QK + d] = ok ? kb[row * k_rs + d] : zero;
      Vs[r * DH + d] = ok ? vb[row * v_rs + d] : zero;
    }
    __syncthreads();

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
      for (int j = 0; j < COLS; ++j) kv[j] = to_f32(Ks[(cg + 8 * j) * QK + d]);
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
        const float vv = to_f32(Vs[cc * DH + cg + 8 * dc]);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][dc] = fmaf(pv[i], vv, acc[i][dc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + ((long long)b * sq + row) * c + (long long)h * DH;
#pragma unroll
    for (int dc = 0; dc < DCOLS; ++dc) orow[cg + 8 * dc] = from_f32<T>(acc[i][dc] * inv);
  }
}

template <int DH>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o, long long q_bs,
                        long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                        long long v_rs, int batch, int sq, int sk, int n_heads,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(bsc_fp32_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, n_heads, batch);
  const float scale_log2 = LOG2E / sqrtf((float)DH);
  bsc_fp32_kernel<DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), q_bs, q_rs, k_bs, k_rs, v_bs,
      v_rs, sq, sk, n_heads * DH, scale_log2);
  return cudaGetLastError();
}

// bf16: the tensor-core template, heads Dh apart in the channel axis; the
// output (B, Sq, C) contiguous
template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, long long q_bs,
                        long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                        long long v_rs, int batch, int sq, int sk, int n_heads,
                        cudaStream_t stream) {
  const long long c = (long long)n_heads * DH;
  const Strides st{q_bs, DH, q_rs, k_bs, DH, k_rs, v_bs, DH, v_rs, sq * c, DH, c};
  return sdt_tc::launch<DH>(q, k, v, o, st, batch, n_heads, sq, sk, stream);
}

cudaError_t dispatch_dh(int dtype, int head_dim, const void* q, const void* k, const void* v,
                        void* o, long long q_bs, long long q_rs, long long k_bs,
                        long long k_rs, long long v_bs, long long v_rs, int batch, int sq,
                        int sk, int n_heads, cudaStream_t stream) {
#define SDT_CASE(D)                                                                    \
  case D:                                                                              \
    return dtype == 0 ? launch_fp32<D>(q, k, v, o, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, \
                                       batch, sq, sk, n_heads, stream)                 \
                      : launch_bf16<D>(q, k, v, o, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, \
                                       batch, sq, sk, n_heads, stream);
  switch (head_dim) {
    SDT_CASE(32)
    SDT_CASE(40)
    SDT_CASE(64)
    SDT_CASE(80)
    SDT_CASE(160)
    default:
      return cudaErrorInvalidValue;
  }
#undef SDT_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns the
// cudaError_t of the launch (0 on success); never synchronizes.
int sdt_flash_attention_bsc(const void* q, const void* k, const void* v, void* o,
                            long long q_bs, long long q_rs, long long k_bs,
                            long long k_rs, long long v_bs, long long v_rs, int batch,
                            int sq, int sk, int n_heads, int head_dim, int dtype,
                            void* stream) {
  if (batch <= 0 || sq <= 0 || n_heads <= 0) return cudaSuccess;
  if (sk <= 0 || n_heads > 65535 || batch > 65535) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  return dispatch_dh(dtype, head_dim, q, k, v, o, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, batch,
                     sq, sk, n_heads, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
