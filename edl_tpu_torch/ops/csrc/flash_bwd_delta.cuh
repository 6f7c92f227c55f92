// The delta pass shared by the flash-attention backward kernels for
// Hopper (sm_90a), flash_bwd.cu (B2) and flash_bwd_streamk.cu (B3):
// delta = rowsum(dO * O) - g_lse in f32, and the 16-bit conversions
// both use.  Each includes this header in its own translation unit;
// nothing here has external linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DELTA_THREADS = 256;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// delta[b*H + h, t] = sum_d dO * O (f32) - g_lse.  D/8 lanes per row,
// 16 bytes each, reduced by shuffles; rows in (b, t, h) order so the
// reads of a warp are contiguous.  The body of a __global__ kernel of
// DELTA_THREADS threads (each file names its own, so a profile tells
// B2's delta pass from B3's).
template <typename T, int D>
__device__ __forceinline__ void delta_rows(
    const T* __restrict__ o, const T* __restrict__ dout,
    const float* __restrict__ glse, float* __restrict__ delta, int B, int H,
    int Tq, long long o_sb, long long o_st, long long o_sh, long long d_sb,
    long long d_st, long long d_sh) {
  constexpr int CH = D / 8;
  const long long gid = (long long)blockIdx.x * DELTA_THREADS + threadIdx.x;
  const long long row = gid / CH;
  const int part = (int)(gid % CH);
  const long long rows = (long long)B * Tq * H;
  float acc = 0.f;
  int b = 0, t = 0, h = 0;
  if (row < rows) {
    h = (int)(row % H);
    t = (int)((row / H) % Tq);
    b = (int)(row / ((long long)H * Tq));
    const uint4 ou = *reinterpret_cast<const uint4*>(o + b * o_sb + t * o_st +
                                                     h * o_sh + part * 8);
    const uint4 du = *reinterpret_cast<const uint4*>(dout + b * d_sb +
                                                     t * d_st + h * d_sh +
                                                     part * 8);
    const T* ov = reinterpret_cast<const T*>(&ou);
    const T* dv = reinterpret_cast<const T*>(&du);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += to_float(ov[j]) * to_float(dv[j]);
  }
#pragma unroll
  for (int off = CH / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (row < rows && part == 0) {
    const long long idx = (long long)(b * H + h) * Tq + t;
    delta[idx] = acc - (glse != nullptr ? glse[idx] : 0.f);
  }
}

template <typename T>
using DeltaKernel = void (*)(const T*, const T*, const float*, float*, int,
                             int, int, long long, long long, long long,
                             long long, long long, long long);

// Launch a delta kernel over every row of [B, Tq, H]; `os`, `ds`: the
// {batch, sequence, head} strides of O and dO.
template <typename T, int D>
cudaError_t launch_delta(DeltaKernel<T> kern, const void* o,
                         const long long* os, const void* dout,
                         const long long* ds, const float* glse,
                         float* delta, int B, int H, int Tq,
                         cudaStream_t stream) {
  const long long threads = (long long)B * Tq * H * (D / 8);
  const unsigned blocks =
      (unsigned)((threads + DELTA_THREADS - 1) / DELTA_THREADS);
  if (blocks == 0) return cudaSuccess;
  kern<<<blocks, DELTA_THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), glse, delta, B,
      H, Tq, os[0], os[1], os[2], ds[0], ds[1], ds[2]);
  return cudaGetLastError();
}

}  // namespace
