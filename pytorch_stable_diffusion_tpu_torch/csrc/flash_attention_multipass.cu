// K3: multi-pass flash attention, head-split (B, H, S, Dh), Dh up to 512, for Hopper.
//
// Replaces the Pallas kernel
//   pytorch_stable_diffusion_tpu/ops/pallas/flash_attention.py::flash_attention
//   (its multi-pass grid, body: _kernel).
// It computes what that kernel computes, softmax(Q K^T / sqrt(Dh)) V for every
// (batch, head), causal or not, over a KV of any length:
//   * scores and softmax in fp32; 1/sqrt(Dh) folded with log2(e) and exp2f;
//   * causal mask col <= row; the KV tail of the last tile masked;
//   * output acc / max(l, 1e-30) in the input dtype, so a row masked in every
//     tile gives 0 (m = -inf is guarded: exp2 of (-inf) - (-inf) would be NaN).
//
// The TPU grid's sequential kv axis, with m, l and acc carried in VMEM
// scratch from one grid step to the next, becomes a loop over KV tiles inside
// one CTA: the CTA owns a (32-row q tile, head, batch) and keeps its running
// m, l and accumulator in registers for the whole walk.  Causal: KV tiles
// wholly above the diagonal are skipped, the diagonal tile is masked per
// element.
//
// The hard part is Dh 512 (the VAE mid block, 1 head).  A 64-row q tile's
// fp32 accumulator is 128 KB and cannot live in 128 threads' registers, so
// the tile is 32 rows and the CTA has 256 threads:
//   * scores (32 x 32 a tile): thread (ty, tx), ty = tid / 16, tx = tid % 16,
//     owns rows ty + 16*i and columns tx + 16*j (i, j < 2), reading Q and K
//     from shared memory 16 bytes at a time; row max and sum reduce over the
//     16 lanes of a half-warp with shuffles;
//   * P goes through shared memory with each row's rescale factor;
//   * P V: thread (pr, pc), pr = tid / 64, pc = tid % 64, owns rows pr + 4*i
//     (i < 8) and output columns pc + 64*c (c < Dh/64): 64 fp32 accumulators
//     a thread at Dh 512.
// Q, K and V are staged in shared memory by 16-byte cp.async copies (the rows
// past Sk zero-filled): 200 KB at Dh 512 in fp32, 103 KB in bf16, above the
// 48 KB default, so the launch raises the dynamic shared-memory limit.
// All products are fp32 FMAs on the CUDA cores.
//
// What bounds it on the H100.  At SD-1.5's 2048² VAE mid block,
// (1, 1, 65536, 512), a call costs 4*Sq*Sk*Dh = 8.8 TFLOP and must move
// 0.27 GB in bf16: compute-bound (8.9 ms at 989 TFLOP/s; the bytes take
// 0.08 ms).  Occupancy: (1, 1, 4096, 512), the 512² VAE on the kernel
// backend, gives 128 CTAs, one wave on 132 SMs; at 65536 tokens 2048 CTAs
// run at 2 CTAs an SM in bf16 and 1 in fp32 (shared memory).  Left on the
// table: the tensor cores (wgmma), a KV ring overlapping loads with math
// (here each tile is loaded, then computed), P in registers.
#include <math_constants.h>

#include "common.cuh"

namespace {

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
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

// Shared-memory layout.  Q and K rows are QK = Dh + one 16-byte chunk apart:
// an odd number of chunks, so the 16 K rows a half-warp reads 16 bytes of at
// one column spread over all banks.
template <typename T, int DH>
struct Layout {
  static_assert(DH % 64 == 0, "head dim must be a multiple of 64");
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int QK = DH + VEC;
  static constexpr int Q_ELEMS = BLOCK_M * QK;
  static constexpr int K_ELEMS = BLOCK_N * QK;
  static constexpr int V_ELEMS = BLOCK_N * DH;
  static constexpr size_t TILE_BYTES = sizeof(T) * (size_t)(Q_ELEMS + K_ELEMS + V_ELEMS);
  static constexpr size_t SMEM = TILE_BYTES + sizeof(float) * (BLOCK_M * P_STRIDE + 2 * BLOCK_M);
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
multipass_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, Strides st, int sq, int sk, int causal,
                 float scale_log2) {
  using L = Layout<T, DH>;
  constexpr int QK = L::QK;
  constexpr int VEC = L::VEC;
  constexpr int PV_COLS = DH / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + L::Q_ELEMS;
  T* Vs = Ks + L::K_ELEMS;
  float* Ps = reinterpret_cast<float*>(smem_raw + L::TILE_BYTES);
  float* alpha_s = Ps + BLOCK_M * P_STRIDE;  // per-row rescale of this tile
  float* l_s = alpha_s + BLOCK_M;            // per-row denominators at the end

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // scores
  const int pr = tid >> 6, pc = tid & 63;  // P V
  const long long h = blockIdx.y;
  const long long b = blockIdx.z;
  const int q0 = blockIdx.x * BLOCK_M;
  const T* qb = q + b * st.q_b + h * st.q_h;
  const T* kb = k + b * st.k_b + h * st.k_h;
  const T* vb = v + b * st.v_b + h * st.v_h;

  load_tile<T, DH, QK, BLOCK_M, THREADS>(Qs, qb, st.q_r, q0, sq, tid);
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
    load_tile<T, DH, QK, BLOCK_N, THREADS>(Ks, kb, st.k_r, kv0, sk, tid);
    load_tile<T, DH, DH, BLOCK_N, THREADS>(Vs, vb, st.v_r, kv0, sk, tid);
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
        const float vv = to_f32(Vs[n * DH + pc + 64 * c]);
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
    T* orow = o + b * st.o_b + h * st.o_h + (long long)row * st.o_r;
#pragma unroll
    for (int c = 0; c < PV_COLS; ++c) orow[pc + 64 * c] = from_f32<T>(acc[i][c] * inv);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const Strides& st,
                   int batch, int n_heads, int sq, int sk, int causal, cudaStream_t stream) {
  const size_t smem = Layout<T, DH>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(multipass_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, n_heads, batch);
  const float scale_log2 = LOG2E / sqrtf((float)DH);
  multipass_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), st, sq, sk, causal, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int head_dim, const void* q, const void* k, const void* v, void* o,
                        const Strides& st, int batch, int n_heads, int sq, int sk,
                        int causal, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch<T, 64>(q, k, v, o, st, batch, n_heads, sq, sk, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, st, batch, n_heads, sq, sk, causal, stream);
    case 512: return launch<T, 512>(q, k, v, o, st, batch, n_heads, sq, sk, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// strides: 12 values in elements, (batch, head, row) for q, k, v, o in that
// order; the head-dim stride is 1.  dtype: 0 = float32, 1 = bfloat16;
// causal: 0 or 1.  Returns the cudaError_t of the launch (0 on success);
// never synchronizes.
int sdt_flash_attention_multipass(const void* q, const void* k, const void* v, void* o,
                                  const long long* strides, int batch, int n_heads, int sq,
                                  int sk, int head_dim, int dtype, int causal,
                                  void* stream) {
  if (batch <= 0 || sq <= 0 || n_heads <= 0) return cudaSuccess;
  if (sk <= 0 || n_heads > 65535 || batch > 65535) return cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],  strides[5],
                   strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(head_dim, q, k, v, o, st, batch, n_heads, sq, sk, causal, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(head_dim, q, k, v, o, st, batch, n_heads, sq, sk,
                                      causal, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
