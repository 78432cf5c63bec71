// K5: fused per-(batch, channel) affine -> SiLU -> 3x3 convolution, for Hopper.
//
// Replaces the Pallas kernel
//   pytorch_stable_diffusion_tpu/ops/pallas/conv.py::scaled_silu_conv3x3
//   (:218, pallas_call :256, body _kernel :53), the body of every UNet
//   res-block half.
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
// i.e. (Cout, 3, 3, Cin): the kernel reads it in place through a tensor map
// over (Cin, tap, Cout) — no per-call permute, no cached copy.
//
// What bounds it on the H100.  A res-block conv costs 2*9*Cin*Cout*H*W*B FLOP
// against x, out and W moved once: (2, 64, 64, 960 -> 320) is 45 GFLOP and
// 10 MB, 0.046 ms at 989 TFLOP/s against 0.003 ms of bytes, so on paper it
// is compute-bound; the 44 convs of a 512² CFG step are 653 GFLOP, 0.66 ms.
// On the card the activation bounds it: every CTA activates its halo
// (affine + SiLU, ~8 instructions an element) for its own output channels,
// and a build without that work ran the main shape far faster.  So a CTA
// takes as many output channels as it can hold (320) and as small a halo as
// a wgmma tile allows (8x8 pixels: 100 halo pixels for 64 outputs), SiLU
// divides with the approximate division (__fdividef), and the small levels,
// which would leave most SMs idle, split Cin.
//
// bf16 design: an implicit GEMM on wgmma, M = output pixels, N = Cout,
// K = 9 x Cin, walked as 64-channel chunks x 9 taps.  One CTA of three
// warpgroups per (8x8-pixel patch, 320 output channels, share of Cin):
//   * a producer warpgroup (setmaxnreg 24) issues every TMA load: per chunk
//     the RAW 10x10-pixel halo (a 4-d map over (Cin, W, H, B), 128-byte
//     swizzle; pixels outside the image come back as zeros) into a ring of
//     two, one chunk ahead, and per (chunk, tap) the 320 x 64 weight tile
//     (two boxes of a 3-d map over (Cin, tap, Cout), 128-byte swizzle) into
//     a ring of four;
//   * two consumer warpgroups, 160 output channels each, activate each raw
//     halo element ONCE (fp32 affine + SiLU, rounded to bf16; pixels outside
//     the image and channels past Cin written as 0, so the padding comes
//     after the activation) into a bf16 halo buffer stored as 8-channel
//     slabs, [slab][halo pixel][8 channels] (the no-swizzle core-matrix
//     layout).  A patch row is 8 consecutive halo pixels, so the A operand
//     of tap (dy, dx) is the same buffer read through a descriptor whose
//     start is (dy*10 + dx)*16 bytes on: core-matrix rows 16 bytes apart,
//     8-row groups (patch rows) one halo row (160 bytes) apart (SBO), k
//     halves one slab apart (LBO).  No im2col, no per-tap copy; the 8x8
//     patch also fits the 8x8 level with no wasted rows;
//   * wgmma m64n160k16 with both operands from shared memory, 4 a tap,
//     two taps in flight; chunk k+1's activation runs in slices between the
//     taps of chunk k, while their products are in flight, into the third
//     of three halo buffers, so the products never drain between chunks;
//   * split K: where (pixel tiles x channel tiles) would not fill the SMs,
//     the Cin chunks are split over a thread-block cluster of up to 8 CTAs
//     along z; each writes its fp32 partial tile to its own shared memory and
//     each reduces a share of the rows over the cluster's partials
//     (distributed shared memory), adds the bias and stores bf16.  One
//     epilogue serves every split count, 1 included (16-byte stores of 8
//     channels).  Shared memory (~225 KB) holds one CTA an SM, so the split
//     is the launch's per-grid occupancy choice.
// Ragged H and W (masked on store), Cout (TMA zero rows, masked on store) and
// Cin (a multiple of 8: TMA zero channels, activations masked to 0).
//
// fp32 path (the FP32 policy's checks): the activated halo staged in fp32 in
// shared memory and a CUDA-core FMA loop, 8x8 pixels x 64 channels a CTA,
// each of 256 threads a 4x4 register tile; no TF32.
#include "common.cuh"
#include "flash_attention_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Geometry {
  int H, W, cin, cout, tiles_w, tiles_per_image;
};

__device__ __forceinline__ float silu(float v) { return v / (1.f + __expf(-v)); }

// ------------------------------------------------------------ bf16 path
namespace tc {

using sdt_tc::bar_sync;
using sdt_tc::fence_regs;
using sdt_tc::mbar_arrive;
using sdt_tc::mbar_expect_tx;
using sdt_tc::mbar_init;
using sdt_tc::mbar_wait;
using sdt_tc::smem_u32;
using sdt_tc::wgmma_commit;
using sdt_tc::wgmma_fence;
using sdt_tc::wgmma_wait;

constexpr int PH = 8, PW = 8;              // patch: 8 x 8 pixels, 64 outputs
constexpr int HH = PH + 2, HW = PW + 2;    // halo 10 x 10
constexpr int HP = HH * HW;                // 100 halo pixels
constexpr int WN = 160;                    // output channels a consumer warpgroup
constexpr int BN = 2 * WN;                 // output channels a CTA
constexpr int BK = 64;                     // input channels a chunk (128-byte rows)
constexpr int THREADS = 384;
constexpr int CONSUMERS = 256;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int W_STAGES = 4;
constexpr int RAW_SLOT = (HP * 128 + 1023) / 1024 * 1024;   // 13312: TMA destination
constexpr int W_TILE = BN * 128;                            // 40960: two boxes
constexpr int SLAB = HP * 16;                               // one 8-channel slab
constexpr int ACT = 8 * SLAB;                               // 12800
constexpr int ITEMS = HP * 8;                               // 16-byte activation items
constexpr int ACT_TAPS = (ITEMS + CONSUMERS - 1) / CONSUMERS;  // taps that carry them
constexpr int RAW_OFF = 0, W_OFF = 2 * RAW_SLOT, ACT_OFF = W_OFF + W_STAGES * W_TILE;
constexpr int BAR_OFF = ACT_OFF + 3 * ACT;
constexpr int SMEM = 1024 + BAR_OFF + 8 * (2 * W_STAGES + 4);
constexpr int RED_PITCH = BN + 8;          // floats; the partial tile reuses offset 0
constexpr int MAX_SPLIT = 8;
constexpr int CONSUMER_BAR = 1;
static_assert(ACT_TAPS <= 9, "activation slices");
static_assert(PH * PW * RED_PITCH * 4 <= ACT_OFF, "partial tile");
static_assert(SMEM <= 227 * 1024, "shared memory");

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return sdt_tc::make_desc(addr, 16, 1024) | (1ull << 62);
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// 16 bytes of the shared memory of cluster CTA `cta` at this CTA's offset `addr`
__device__ __forceinline__ float4 ld_cluster(uint32_t addr, uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(cta));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// SiLU with the approximate division (2 ulp; x / (1 + e^-x) as an IEEE
// division is ~20 instructions, and the activation is what bounds this
// kernel: a build without it ran far faster on the card)
__device__ __forceinline__ float silu_fast(float v) { return __fdividef(v, 1.f + __expf(-v)); }
__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// grid: x = pixel tiles (batch-major), y = channel tiles, z = Cin splits (a
// cluster along z)
__global__ void __launch_bounds__(THREADS, 1)
conv_tc_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
               const float* __restrict__ scale, const float* __restrict__ shift,
               const float* __restrict__ bias, bf16* __restrict__ out, Geometry g) {
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const uint32_t raw0 = smem_u32(smem_tc);
  const uint32_t base = (raw0 + 1023) & ~1023u;
  unsigned char* smem = smem_tc + (base - raw0);
  const uint32_t w_full = base + BAR_OFF, w_empty = w_full + 8 * W_STAGES;
  const uint32_t x_full = w_empty + 8 * W_STAGES, x_empty = x_full + 16;

  const int tid = threadIdx.x, wg = tid / 128;
  const int b = blockIdx.x / g.tiles_per_image;
  const int r = blockIdx.x - b * g.tiles_per_image;
  const int y0 = (r / g.tiles_w) * PH, x0 = (r % g.tiles_w) * PW;
  const int n0 = blockIdx.y * BN;
  const int split = gridDim.z, z = blockIdx.z;
  const int n_chunks = (g.cin + BK - 1) / BK;
  const int kb = z * n_chunks / split, ke = (z + 1) * n_chunks / split;
  const int nk = ke - kb;

  if (tid == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(x_full + 8 * s, 1);
      mbar_init(x_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ---------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      auto load_x = [&](int i) {  // the raw halo of chunk kb + i
        const int slot = i % 2;
        if (i >= 2) mbar_wait(x_empty + 8 * slot, (i / 2 - 1) & 1);
        mbar_expect_tx(x_full + 8 * slot, HP * 128);
        sdt_tc::tma_load(base + RAW_OFF + slot * RAW_SLOT, &tm_x, x_full + 8 * slot,
                         (kb + i) * BK, x0 - 1, y0 - 1, b);
      };
      if (nk > 0) load_x(0);
      for (int i = 0; i < nk; ++i) {
        if (i + 1 < nk) load_x(i + 1);  // one chunk ahead of the weights
        for (int tap = 0; tap < 9; ++tap) {
          const int u = 9 * i + tap, st = u % W_STAGES;
          if (u >= W_STAGES) mbar_wait(w_empty + 8 * st, (u / W_STAGES - 1) & 1);
          mbar_expect_tx(w_full + 8 * st, W_TILE);
          for (int h = 0; h < 2; ++h)  // a box of 160 output channels a warpgroup
            tma_load_3d(base + W_OFF + st * W_TILE + h * WN * 128, &tm_w, w_full + 8 * st,
                        (kb + i) * BK, tap, n0 + h * WN);
        }
      }
    }
    __syncwarp();
    cluster_sync();  // the partial tiles are written
    cluster_sync();  // and read
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int w = wg - 1;  // output channels n0 + WN w ..
  const int ct = tid - 128, t = tid % 128;
  const int warp = t / 32, lane = t % 32;
  const float* sc = scale + (long long)b * g.cin;
  const float* sh = shift + (long long)b * g.cin;

  // one 16-byte item of the activation: 8 channels of one halo pixel
  auto activate = [&](int item, int i) {
    const int slab = item / HP, hp = item - slab * HP;
    const int hy = hp / HW, hx = hp - hy * HW;
    const int gy = y0 - 1 + hy, gx = x0 - 1 + hx, c = (kb + i) * BK + 8 * slab;
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < g.H && gx >= 0 && gx < g.W && c < g.cin) {
      const uint4 rv = *reinterpret_cast<const uint4*>(
          smem + RAW_OFF + (i % 2) * RAW_SLOT + hp * 128 + ((slab ^ (hp & 7)) << 4));
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(sc + c));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(sc + c + 4));
      const float4 t0 = __ldg(reinterpret_cast<const float4*>(sh + c));
      const float4 t1 = __ldg(reinterpret_cast<const float4*>(sh + c + 4));
      o.x = sdt_tc::pack_bf16(silu_fast(fmaf(bf16_lo(rv.x), s0.x, t0.x)),
                              silu_fast(fmaf(bf16_hi(rv.x), s0.y, t0.y)));
      o.y = sdt_tc::pack_bf16(silu_fast(fmaf(bf16_lo(rv.y), s0.z, t0.z)),
                              silu_fast(fmaf(bf16_hi(rv.y), s0.w, t0.w)));
      o.z = sdt_tc::pack_bf16(silu_fast(fmaf(bf16_lo(rv.z), s1.x, t1.x)),
                              silu_fast(fmaf(bf16_hi(rv.z), s1.y, t1.y)));
      o.w = sdt_tc::pack_bf16(silu_fast(fmaf(bf16_lo(rv.w), s1.z, t1.z)),
                              silu_fast(fmaf(bf16_hi(rv.w), s1.w, t1.w)));
    }
    *reinterpret_cast<uint4*>(smem + ACT_OFF + (i % 3) * ACT + slab * SLAB + hp * 16) = o;
  };
  auto release_x = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(x_empty + 8 * (i % 2));
  };

  float acc[WN / 2];
#pragma unroll
  for (int e = 0; e < WN / 2; ++e) acc[e] = 0.f;

  if (nk > 0) {  // the first chunk's activation, whole
    mbar_wait(x_full, 0);
    for (int item = ct; item < ITEMS; item += CONSUMERS) activate(item, 0);
    release_x(0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(CONSUMER_BAR, CONSUMERS);
  }
  for (int i = 0; i < nk; ++i) {
    const bool next = i + 1 < nk;
    // A: the patch's 8 rows of 8 pixels, k halves one slab apart (both
    // warpgroups read the same halo)
    const uint32_t act = base + ACT_OFF + (i % 3) * ACT;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int u = 9 * i + tap, st = u % W_STAGES;
      const int dy = tap / 3, dx = tap - 3 * dy;
      mbar_wait(w_full + 8 * st, (u / W_STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t a =
            sdt_tc::make_desc(act + (dy * HW + dx) * 16 + kk * 2 * SLAB, SLAB, HW * 16);
        const uint64_t bd = desc_sw128(base + W_OFF + st * W_TILE + w * WN * 128 + kk * 32);
        sdt_wgmma::MmaSS<WN, 0>::run(acc, a, bd, 1);
      }
      wgmma_commit();
      if (next && tap < ACT_TAPS) {  // a slice of the next chunk's activation
        if (tap == 0) mbar_wait(x_full + 8 * ((i + 1) % 2), ((i + 1) / 2) & 1);
        const int item = tap * CONSUMERS + ct;
        if (item < ITEMS) activate(item, i + 1);
        if (tap == ACT_TAPS - 1) release_x(i + 1);
      }
      wgmma_wait<1>();  // the previous tap, possibly the last of the previous chunk
      fence_regs(acc);
      if (u > 0 && lane == 0) mbar_arrive(w_empty + 8 * ((u - 1) % W_STAGES));
    }
    // the next halo is whole, and chunk i-1's products are done in both
    // warpgroups, so the buffer it read can take chunk i+2's halo
    if (next) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(CONSUMER_BAR, CONSUMERS);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (lane == 0) mbar_arrive(w_empty + 8 * ((9 * nk - 1) % W_STAGES));
  bar_sync(CONSUMER_BAR, CONSUMERS);  // both warpgroups' products are done

  // epilogue: the fp32 partial tile [64 pixels][320 channels] at offset 0
  // (the halo and weight rings are idle now: every load was waited for)
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < WN / 8; ++i)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int m = 16 * warp + lane / 4 + 8 * rr, n = WN * w + 8 * i + 2 * (lane % 4);
      *reinterpret_cast<float2*>(part + m * RED_PITCH + n) =
          make_float2(acc[4 * i + 2 * rr], acc[4 * i + 2 * rr + 1]);
    }
  cluster_sync();
  // this CTA's share of the rows, summed over the cluster's partial tiles
  const uint32_t rank = split > 1 ? cluster_rank() : 0;
  const int m0 = rank * PH * PW / split, m1 = (rank + 1) * PH * PW / split;
  for (int item = ct; item < (m1 - m0) * (BN / 8); item += CONSUMERS) {
    const int m = m0 + item / (BN / 8), n = 8 * (item % (BN / 8));
    const int gy = y0 + m / 8, gx = x0 + m % 8, co = n0 + n;  // m = 8 * patch row + column
    if (gy >= g.H || gx >= g.W || co >= g.cout) continue;
    const uint32_t addr = base + (m * RED_PITCH + n) * 4;
    float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
    for (int c = 0; c < split; ++c) {
      const float4 a = ld_cluster(addr, c), a1 = ld_cluster(addr + 16, c);
      s0.x += a.x; s0.y += a.y; s0.z += a.z; s0.w += a.w;
      s1.x += a1.x; s1.y += a1.y; s1.z += a1.z; s1.w += a1.w;
    }
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias + co));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(bias + co + 4));
    uint4 o;
    o.x = sdt_tc::pack_bf16(s0.x + b0.x, s0.y + b0.y);
    o.y = sdt_tc::pack_bf16(s0.z + b0.z, s0.w + b0.w);
    o.z = sdt_tc::pack_bf16(s1.x + b1.x, s1.y + b1.y);
    o.w = sdt_tc::pack_bf16(s1.z + b1.z, s1.w + b1.w);
    *reinterpret_cast<uint4*>(out + (((long long)b * g.H + gy) * g.W + gx) * g.cout + co) = o;
  }
  cluster_sync();  // the peers are done reading this CTA's partial tile
}

// the Cin split: doubled (up to 8 CTAs a cluster, and no more than the
// chunks) while the grid still fits in one wave of the SMs
int pick_split(long long tiles, int n_chunks, int sms) {
  int split = 1;
  while (split < MAX_SPLIT && tiles * split * 2 <= sms && 2 * split <= n_chunks) split *= 2;
  return split;
}

cudaError_t launch(const void* x, const void* scale, const void* shift, const void* w,
                   const void* bias, void* out, int batch, int H, int W, int cin, int cout,
                   cudaStream_t stream) {
  sdt_tc::EncodeTiled encode = sdt_tc::encode_tiled();
  if (encode == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  {  // x: (Cin, W, H, B), boxes of 64 channels x 10 x 10 pixels
    const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)W * cin * 2,
                                   (cuuint64_t)H * W * cin * 2};
    const cuuint32_t box[4] = {BK, HW, HH, 1}, elem[4] = {1, 1, 1, 1};
    if (encode(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
               box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  {  // w: (Cin, tap, Cout), boxes of 64 channels x 1 tap x 160 outputs
    const cuuint64_t dims[3] = {(cuuint64_t)cin, 9, (cuuint64_t)cout};
    const cuuint64_t strides[2] = {(cuuint64_t)cin * 2, (cuuint64_t)9 * cin * 2};
    const cuuint32_t box[3] = {BK, 1, WN}, elem[3] = {1, 1, 1};
    if (encode(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides,
               box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return attr;
  Geometry g{H, W, cin, cout, (W + PW - 1) / PW, 0};
  g.tiles_per_image = ((H + PH - 1) / PH) * g.tiles_w;
  const long long tiles = (long long)batch * g.tiles_per_image;
  const int n_tiles = (cout + BN - 1) / BN;
  if (tiles > 0x7fffffffLL || n_tiles > 65535) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int split = pick_split(tiles * n_tiles, (cin + BK - 1) / BK, sms);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles, n_tiles, split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = split;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, conv_tc_kernel, tx, tw,
                                       static_cast<const float*>(scale),
                                       static_cast<const float*>(shift),
                                       static_cast<const float*>(bias), static_cast<bf16*>(out), g);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace tc

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
// every pointer 16-byte aligned.  Returns the cudaError_t of the launch (0 on
// success); never synchronizes.
int sdt_scaled_silu_conv3x3(const void* x, const void* scale, const void* shift,
                            const void* w, const void* bias, void* out, int batch, int H,
                            int W, int cin, int cout, int dtype, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || cout <= 0) return cudaSuccess;
  if (cin <= 0 || cin % 8 || cout % 8) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return tc::launch(x, scale, shift, w, bias, out, batch, H, W, cin, cout, s);
  if (dtype == 0) {
    Geometry g{H, W, cin, cout, 0, 0};
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

// The bf16 kernel's launch configuration: weight-ring stages, dynamic shared
// memory (bytes), CTAs an SM, and the Cin split a (batch, H, W, Cin, Cout)
// call takes.  Returns a cudaError_t.
int sdt_scaled_silu_conv3x3_config(int batch, int H, int W, int cin, int cout, int* stages,
                                   int* smem, int* ctas, int* split) {
  *stages = tc::W_STAGES;
  *smem = tc::SMEM;
  cudaError_t err = cudaFuncSetAttribute(tc::conv_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, tc::conv_tc_kernel, tc::THREADS,
                                                        tc::SMEM);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)batch * ((H + tc::PH - 1) / tc::PH) *
                          ((W + tc::PW - 1) / tc::PW) * ((cout + tc::BN - 1) / tc::BN);
  *split = tc::pick_split(tiles, (cin + tc::BK - 1) / tc::BK, sms);
  return cudaSuccess;
}

}  // extern "C"
