// Helpers shared by the kernels of csrc/ (the copy helpers by the attention
// kernels; the exported error string by all).
//
// Each kernel source includes this header once and is built into its own
// shared library (ops/cuda/build.py, which also hashes this header into the
// library name), so the definitions here, the exported error string
// included, exist once per library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16-byte asynchronous copy global -> shared; `valid` false fills the 16
// bytes with zeros (src-size 0) without reading global memory.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of rows [row0, row0 + TILE) of a (rows, DH) matrix with row
// stride `rs` (elements, 64-bit) into a shared tile with row stride LD, with
// NTHREADS threads of the CTA; rows >= n_rows read as 0.  Needs 16-byte
// aligned rows in global and shared memory.
template <typename T, int DH, int LD, int TILE, int NTHREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs, int row0,
                                          int n_rows, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = DH / VEC;  // 16-byte chunks per row
  for (int c = tid; c < TILE * CPR; c += NTHREADS) {
    const int r = c / CPR, ch = c - r * CPR;
    const int row = row0 + r;
    const bool ok = row < n_rows;
    const T* g = ok ? src + (long long)row * rs + ch * VEC : src;
    cp_async16(dst + r * LD + ch * VEC, g, ok);
  }
}

// (batch, head, row) strides in elements of q, k, v and the output of a
// head-split (B, H, S, Dh) call; the head-dim stride is 1
struct Strides {
  long long q_b, q_h, q_r, k_b, k_h, k_r, v_b, v_h, v_r, o_b, o_h, o_r;
};

}  // namespace

extern "C" const char* sdt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
