// K5: fused per-(batch, channel) affine -> SiLU -> 3x3 convolution, for Hopper.
//
// Replaces the Pallas kernel
//   pytorch_stable_diffusion_tpu/ops/pallas/conv.py::scaled_silu_conv3x3
//   (body: _kernel), the body of every UNet res-block half.
// It computes what that kernel computes,
//   out[b, y, x, :] = bias + sum_{dy, dx} a[b, y + dy - 1, x + dx - 1, :] . W[:, :, dy, dx]
//   with a = silu(x * scale[b, c] + shift[b, c]) inside the image and 0 outside:
//   the zero padding is applied AFTER the activation (a border pixel is 0,
//   not silu(shift)).  scale/shift are the folded GroupNorm affine (and the
//   time-embedding add) in fp32; the activation is computed in fp32 and
//   rounded to the input dtype before the products, as the TPU kernel does;
//   products accumulate in fp32; the bias is added in fp32.
//
// Layouts.  x and out are NHWC memory (the port's channels_last (B, C, H, W)
// tensors).  The weight is the port's OIHW parameter in channels_last memory,
// i.e. (Cout, 3, 3, Cin): for each output channel the nine taps follow each
// other with Cin contiguous, so the kernel reads the parameter in place — no
// per-call permute, no cached copy.  Offsets are 64-bit products: an
// (8, 256, 256, 960) activation holds 5e8 elements.
//
// bf16 path: an implicit GEMM on the tensor cores, M = B*H*W output pixels,
// N = Cout, K = 9*Cin.  One CTA of 128 threads (2x2 warps, 64x32 outputs
// each) owns an 8x16-pixel patch of one image and 64 output channels, and
// walks Cin in chunks of 16.  For each chunk it stages in shared memory
//   * the ACTIVATED halo, 10x18 pixels x 16 channels: read raw with 16-byte
//     loads, x*scale+shift and SiLU in fp32, stored as bf16 (pixels outside
//     the image stored as 0).  Each input element is activated 180/128 =
//     1.4x per CTA instead of 9x as an im2col would;
//   * the chunk's weights for all nine taps (64 x 16 per tap), by cp.async.
// The nine taps then read shifted windows of the same halo: per tap and
// warp, 4 ldmatrix.x4 of A (one m16 tile is one 16-pixel row of the patch,
// so the tap's shift is just another row address per lane), 2 ldmatrix.x4 of
// B and 16 mma.sync.m16n8k16 (bf16 in, fp32 accumulate).  Shared rows are 48
// bytes apart, so the 8 rows an ldmatrix phase reads fall in distinct banks.
// Two stages: chunk k+1's weights are in flight (cp.async) and its raw halo
// in registers while chunk k computes; the halo is activated and stored after
// the math.  Ragged edges (H, W not multiples of the patch, Cout not a
// multiple of 64, Cin not a multiple of 16) are masked: halo and weight
// vectors past the edge are zero, stores past it are skipped.
//
// fp32 path (the FP32 policy's checks): the same halo staging in fp32 and a
// CUDA-core FMA loop, 8x8 pixels x 64 channels a CTA, each of 256 threads a
// 4x4 register tile; no TF32.
//
// What bounds it on the H100.  At SD-1.5 512² a res-block conv costs
// 2*9*Cin*Cout*H*W*B FLOP against x, out and W moved once: e.g. (2, 64, 64,
// 960 -> 320) is 45 GFLOP and 10 MB, 0.046 ms at 989 TFLOP/s against 0.003
// ms of bytes, so it is compute-bound; the 44 convs of a CFG step are 653
// GFLOP, 0.66 ms.  This design reaches a fraction of the tensor-core peak:
// mma.sync instead of wgmma, two stages only, the activation on the CUDA
// cores inside the main loop, 8x16 patches that waste half their rows on
// the 8x8 level, and few CTAs there (B = 2: 40 CTAs at Cout 1280).
// Left for later: wgmma fed by TMA through a multi-stage ring, split-K at
// the 8x8 level.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ bf16 path
constexpr int TH = 8;                    // patch rows
constexpr int TW = 16;                   // patch columns: one m16 tile a row
constexpr int BN = 64;                   // output channels a CTA
constexpr int BK = 16;                   // input channels a chunk
constexpr int HALO_W = TW + 2;
constexpr int HALO = (TH + 2) * HALO_W;  // 180 halo pixels
constexpr int LD = BK + 8;               // shared row stride: 48 B
constexpr int THREADS = 128;
constexpr int HALO_VECS = HALO * BK / 8;  // 16-byte vectors of 8 channels
constexpr int HALO_ITEMS = (HALO_VECS + THREADS - 1) / THREADS;
constexpr int W_VECS = 9 * BN * BK / 8;
constexpr int HALO_ELEMS = HALO * LD;
constexpr int STAGE_ELEMS = HALO_ELEMS + 9 * BN * LD;
constexpr size_t SMEM_BYTES = 2 * STAGE_ELEMS * sizeof(bf16);
static_assert(HALO_ELEMS * sizeof(bf16) % 16 == 0, "weights must start 16-byte aligned");

struct Geometry {
  int H, W, cin, cout, tiles_w, tiles_per_image;
};

__device__ __forceinline__ float silu(float v) { return v / (1.f + __expf(-v)); }

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// Halo vector i: pixel i / 2 of the (TH+2)x(TW+2) window, channels
// c0 + 8*(i % 2) .. +7.  Returns whether it lies in the image and in Cin,
// and its global element offset within image b.
__device__ __forceinline__ bool halo_vec(int i, const Geometry& g, int y0, int x0, int c0,
                                         long long& off, int& c) {
  const int hp = i >> 1;
  const int hy = hp / HALO_W, hx = hp - hy * HALO_W;
  const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
  c = c0 + (i & 1) * 8;
  off = ((long long)gy * g.W + gx) * g.cin + c;
  return gy >= 0 && gy < g.H && gx >= 0 && gx < g.W && c < g.cin;
}

// Start the raw halo loads of the chunk at c0 into registers.
__device__ __forceinline__ void load_halo(uint4 (&raw)[HALO_ITEMS], const bf16* xb,
                                          const Geometry& g, int y0, int x0, int c0,
                                          int tid) {
#pragma unroll
  for (int j = 0; j < HALO_ITEMS; ++j) {
    const int i = tid + j * THREADS;
    raw[j] = make_uint4(0u, 0u, 0u, 0u);
    long long off;
    int c;
    if (i < HALO_VECS && halo_vec(i, g, y0, x0, c0, off, c))
      raw[j] = __ldg(reinterpret_cast<const uint4*>(xb + off));
  }
}

// Activate the raw halo (fp32 affine + SiLU, rounded to bf16) into shared
// memory; vectors outside the image or past Cin are stored as zeros.
__device__ __forceinline__ void store_halo(bf16* hs, const uint4 (&raw)[HALO_ITEMS],
                                           const float* sc, const float* sh,
                                           const Geometry& g, int y0, int x0, int c0,
                                           int tid) {
#pragma unroll
  for (int j = 0; j < HALO_ITEMS; ++j) {
    const int i = tid + j * THREADS;
    if (i >= HALO_VECS) continue;
    long long off;
    int c;
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (halo_vec(i, g, y0, x0, c0, off, c)) {
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(sc + c));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(sc + c + 4));
      const float4 t0 = __ldg(reinterpret_cast<const float4*>(sh + c));
      const float4 t1 = __ldg(reinterpret_cast<const float4*>(sh + c + 4));
      const uint4 r = raw[j];
      o.x = pack_bf16x2(silu(fmaf(bf16_lo(r.x), s0.x, t0.x)), silu(fmaf(bf16_hi(r.x), s0.y, t0.y)));
      o.y = pack_bf16x2(silu(fmaf(bf16_lo(r.y), s0.z, t0.z)), silu(fmaf(bf16_hi(r.y), s0.w, t0.w)));
      o.z = pack_bf16x2(silu(fmaf(bf16_lo(r.z), s1.x, t1.x)), silu(fmaf(bf16_hi(r.z), s1.y, t1.y)));
      o.w = pack_bf16x2(silu(fmaf(bf16_lo(r.w), s1.z, t1.z)), silu(fmaf(bf16_hi(r.w), s1.w, t1.w)));
    }
    *reinterpret_cast<uint4*>(hs + (i >> 1) * LD + (i & 1) * 8) = o;
  }
}

// Start the copies of the chunk's weights, all nine taps of BN output
// channels: row tap*BN + n of the stage holds W[n0 + n, tap, c0 .. c0 + 15].
__device__ __forceinline__ void load_weights(bf16* ws, const bf16* w, const Geometry& g,
                                             int n0, int c0, int tid) {
  for (int i = tid; i < W_VECS; i += THREADS) {
    const int row = i >> 1;
    const int tap = row / BN, n = row - tap * BN;
    const int co = n0 + n, c = c0 + (i & 1) * 8;
    const bool ok = co < g.cout && c < g.cin;
    const bf16* src = ok ? w + ((long long)co * 9 + tap) * g.cin + c : w;
    cp_async16(ws + row * LD + (i & 1) * 8, src, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

__global__ void __launch_bounds__(THREADS)
conv_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ shift, const bf16* __restrict__ w,
                 const float* __restrict__ bias, bf16* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int b = blockIdx.x / g.tiles_per_image;
  const int r = blockIdx.x - b * g.tiles_per_image;
  const int y0 = (r / g.tiles_w) * TH;
  const int x0 = (r % g.tiles_w) * TW;
  const int n0 = blockIdx.y * BN;
  const bf16* xb = x + (long long)b * g.H * g.W * g.cin;
  const float* sc = scale + (long long)b * g.cin;
  const float* sh = shift + (long long)b * g.cin;

  // per-lane ldmatrix rows: A row = patch column (lane & 15) of the warp's
  // m16 tile, k half (lane >> 4); B row = output channel of the n16 pair
  const int a_col = lane & 15, a_k = (lane >> 4) * 8;
  const int b_row = wn * 32 + (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) * 8;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  uint4 raw[HALO_ITEMS];
  load_weights(smem + HALO_ELEMS, w, g, n0, 0, tid);
  cp_async_commit();
  load_halo(raw, xb, g, y0, x0, 0, tid);
  store_halo(smem, raw, sc, sh, g, y0, x0, 0, tid);
  cp_async_wait<0>();
  __syncthreads();

  const int n_chunks = (g.cin + BK - 1) / BK;
  for (int k = 0; k < n_chunks; ++k) {
    const bf16* hs = smem + (k & 1) * STAGE_ELEMS;
    const bf16* ws = hs + HALO_ELEMS;
    bf16* next = smem + ((k + 1) & 1) * STAGE_ELEMS;
    const bool more = k + 1 < n_chunks;
    if (more) {
      load_weights(next + HALO_ELEMS, w, g, n0, (k + 1) * BK, tid);
      cp_async_commit();
      load_halo(raw, xb, g, y0, x0, (k + 1) * BK, tid);
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
      unsigned a[4][4], bm[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(a[mi], hs + ((wm * 4 + mi + dy) * HALO_W + a_col + dx) * LD + a_k);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4(bm[nj], ws + (tap * BN + b_row + nj * 16) * LD + b_k);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi], bm[ni >> 1][(ni & 1) * 2],
                   bm[ni >> 1][(ni & 1) * 2 + 1]);
    }
    if (more) store_halo(next, raw, sc, sh, g, y0, x0, (k + 1) * BK, tid);
    cp_async_wait<0>();
    __syncthreads();
  }

  // epilogue: thread holds rows (lane / 4) and (lane / 4 + 8) of each m16
  // tile, channels 2 * (lane % 4) and +1 of each n8 tile
  const int gr = lane >> 2, gc = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int gy = y0 + wm * 4 + mi;
    if (gy >= g.H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gx = x0 + gr + half * 8;
      if (gx >= g.W) continue;
      bf16* orow = out + (((long long)b * g.H + gy) * g.W + gx) * g.cout;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int co = n0 + wn * 32 + ni * 8 + gc;
        if (co >= g.cout) continue;
        const float v0 = acc[mi][ni][half * 2] + bias[co];
        const float v1 = acc[mi][ni][half * 2 + 1] + bias[co + 1];
        *reinterpret_cast<__nv_bfloat162*>(orow + co) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// ------------------------------------------------------------ fp32 path
constexpr int F_T = 8;                     // 8x8-pixel patch
constexpr int F_BN = 64;                   // output channels a CTA
constexpr int F_BK = 8;                    // input channels a chunk
constexpr int F_HALO_W = F_T + 2;
constexpr int F_HALO = F_HALO_W * F_HALO_W;
constexpr int F_THREADS = 256;             // 16 pixel groups x 16 channel groups

__global__ void __launch_bounds__(F_THREADS)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ shift, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out, Geometry g) {
  __shared__ float hs[F_HALO][F_BK];
  __shared__ float ws[9][F_BK][F_BN];

  const int tid = threadIdx.x;
  const int tp = tid >> 4, tn = tid & 15;  // pixels tp + 16 i, channels tn + 16 j
  const int b = blockIdx.x / g.tiles_per_image;
  const int r = blockIdx.x - b * g.tiles_per_image;
  const int y0 = (r / g.tiles_w) * F_T;
  const int x0 = (r % g.tiles_w) * F_T;
  const int n0 = blockIdx.y * F_BN;
  const float* xb = x + (long long)b * g.H * g.W * g.cin;
  const float* sc = scale + (long long)b * g.cin;
  const float* sh = shift + (long long)b * g.cin;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < g.cin; c0 += F_BK) {
    __syncthreads();  // the previous chunk's reads are done
    for (int e = tid; e < F_HALO * F_BK; e += F_THREADS) {
      const int hp = e / F_BK, k = e - hp * F_BK;
      const int hy = hp / F_HALO_W, hx = hp - hy * F_HALO_W;
      const int gy = y0 - 1 + hy, gx = x0 - 1 + hx, c = c0 + k;
      float v = 0.f;  // the padding is zero after the activation
      if (gy >= 0 && gy < g.H && gx >= 0 && gx < g.W)
        v = silu(fmaf(xb[((long long)gy * g.W + gx) * g.cin + c], sc[c], sh[c]));
      hs[hp][k] = v;
    }
    for (int e = tid; e < 9 * F_BN * F_BK; e += F_THREADS) {
      const int k = e % F_BK, rest = e / F_BK;
      const int n = rest % F_BN, tap = rest / F_BN;
      const int co = n0 + n;
      ws[tap][k][n] = co < g.cout ? w[((long long)co * 9 + tap) * g.cin + c0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
#pragma unroll
      for (int k = 0; k < F_BK; ++k) {
        float av[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = tp + 16 * i;
          av[i] = hs[((p >> 3) + dy) * F_HALO_W + (p & 7) + dx][k];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = ws[tap][k][tn + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = tp + 16 * i;
    const int gy = y0 + (p >> 3), gx = x0 + (p & 7);
    if (gy >= g.H || gx >= g.W) continue;
    float* orow = out + (((long long)b * g.H + gy) * g.W + gx) * g.cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tn + 16 * j;
      if (co < g.cout) orow[co] = acc[i][j] + bias[co];
    }
  }
}

}  // namespace

extern "C" {

// x, out: NHWC (B, H, W, Cin) / (B, H, W, Cout); scale, shift: fp32 (B, Cin);
// w: (Cout, 3, 3, Cin); bias: fp32 (Cout,).  dtype: 0 = float32 (CUDA-core
// path), 1 = bfloat16 (tensor cores).  Cin and Cout must be multiples of 8,
// x and w 16-byte aligned.  Returns the cudaError_t of the launch (0 on
// success); never synchronizes.
int sdt_scaled_silu_conv3x3(const void* x, const void* scale, const void* shift,
                            const void* w, const void* bias, void* out, int batch, int H,
                            int W, int cin, int cout, int dtype, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || cout <= 0) return cudaSuccess;
  if (cin <= 0 || cin % 8 || cout % 8) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geometry g{H, W, cin, cout, 0, 0};
  if (dtype == 1) {
    g.tiles_w = (W + TW - 1) / TW;
    g.tiles_per_image = ((H + TH - 1) / TH) * g.tiles_w;
    const long long tiles = (long long)batch * g.tiles_per_image;
    const int n_tiles = (cout + BN - 1) / BN;
    if (tiles > 0x7fffffffLL || n_tiles > 65535) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        conv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    conv_bf16_kernel<<<dim3((unsigned)tiles, n_tiles), THREADS, SMEM_BYTES, s>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<const bf16*>(w),
        static_cast<const float*>(bias), static_cast<bf16*>(out), g);
    return cudaGetLastError();
  }
  if (dtype == 0) {
    g.tiles_w = (W + F_T - 1) / F_T;
    g.tiles_per_image = ((H + F_T - 1) / F_T) * g.tiles_w;
    const long long tiles = (long long)batch * g.tiles_per_image;
    const int n_tiles = (cout + F_BN - 1) / F_BN;
    if (tiles > 0x7fffffffLL || n_tiles > 65535) return cudaErrorInvalidValue;
    conv_f32_kernel<<<dim3((unsigned)tiles, n_tiles), F_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), g);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
