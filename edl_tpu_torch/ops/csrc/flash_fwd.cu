// Flash-attention forward for Hopper (sm_90a): O and the per-row
// logsumexp of softmax(scale * Q K^T) V, causal or with a [B, Tk] key
// mask, without the [T, T] score matrix ever reaching device memory.
//
// Replaces the TPU kernel edl_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd_3d).  Same function, designed for the card
// rather than copied tile by tile:
//
// - One thread block (4 warps) per (batch*head, 64-row Q tile); the
//   TPU's sequential grid over K blocks becomes a loop inside the
//   block over 64-key K/V tiles staged in shared memory.  Each warp
//   owns 16 query rows.
// - Q K^T and P V run on the tensor cores through WMMA 16x16x16
//   (bf16 or f16 operands, f32 accumulation).  The scale applies to
//   the f32 product; P is cast to the input type before P V, as the
//   TPU kernel's p.astype(vb.dtype) does.
// - The online softmax keeps each row's running max and sum in f32
//   registers (two lanes per row); the f32 O accumulator lives in
//   shared memory and is rescaled by exp(m_old - m_new) per tile.
// - Causal: K tiles wholly above the diagonal are never loaded, and
//   only tiles that cross the diagonal (or the ragged end of Tk, or a
//   key mask) pay the per-element mask.  Q rows and keys past the
//   sequence end are zero-filled and masked here, so any T works
//   (the TPU kernel picked a divisor tile size instead).
// - A fully masked row gives O = 0 and lse = log(1e-30), as _safe and
//   l_safe do in the TPU kernel.  No atomics: the output is
//   deterministic.
// - Q, K and V are read in place from [B, T, H, D] with arbitrary
//   batch/sequence/head strides (the slices of a fused QKV projection
//   need no copy); O is written contiguous [B, Tq, H, D], lse
//   contiguous [B, H, Tq] float32.
//
// Bound on the H100 at the serving shape (B=1, T=2048, H=12, D=64,
// causal): 4*B*H*D*T*(T+1)/2 = 6.44 GFLOP on the tensor cores, 6.5 us
// at 989 TFLOP/s dense bf16, against 12.6 MB of Q/K/V/O, 3.8 us at
// 3.35 TB/s — compute-bound.  This first version (WMMA, shared-memory
// round trips for S and O, no TMA or wgmma) is built to be right; its
// measured time is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;  // query rows per block: 4 warps x 16 rows
constexpr int BK = 64;  // keys per K/V tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

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

// _safe: a row max still at NEG_INF (nothing attended yet) counts as 0,
// so exp(NEG_INF - 0) == 0 rather than exp(0) == 1.
__device__ __forceinline__ float safe_max(float m) {
  return m <= NEG_INF * 0.5f ? 0.f : m;
}

// Shared-memory layout.  Rows are padded (8 16-bit or 4 f32 values) so
// the WMMA tiles of consecutive rows fall in different banks; every
// region and every 16-row tile offset stays 32-byte aligned, as
// load/store_matrix_sync require.
template <int D>
struct Smem {
  static constexpr int LDQ = D + 8;   // Q, K, V rows (16-bit)
  static constexpr int LDS = BK + 4;  // S rows (f32)
  static constexpr int LDP = BK + 8;  // P rows (16-bit)
  static constexpr int LDO = D + 4;   // O accumulator rows (f32)
  static constexpr size_t q_bytes = size_t(BQ) * LDQ * 2;
  static constexpr size_t kv_bytes = size_t(BK) * LDQ * 2;
  static constexpr size_t s_bytes = size_t(BQ) * LDS * 4;
  static constexpr size_t p_bytes = size_t(BQ) * LDP * 2;
  static constexpr size_t o_bytes = size_t(BQ) * LDO * 4;
  static constexpr size_t k_off = q_bytes;
  static constexpr size_t v_off = k_off + kv_bytes;
  static constexpr size_t s_off = v_off + kv_bytes;
  static constexpr size_t p_off = s_off + s_bytes;
  static constexpr size_t o_off = p_off + p_bytes;
  static constexpr size_t total = o_off + o_bytes;
};

// Stage rows [row0, row0 + 64) of one (batch, head) slice into shared
// memory, 16 bytes per thread per step; rows at or past n_rows are
// zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride, int row0,
                                          int n_rows, int tid) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  constexpr int LD = Smem<D>::LDQ;
  for (int i = tid; i < BQ * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Tq,
                 int Tk, long long q_sb, long long q_st, long long q_sh,
                 long long k_sb, long long k_st, long long k_sh,
                 long long v_sb, long long v_st, long long v_sh, float scale,
                 int causal) {
  using S = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = reinterpret_cast<T*>(smem + S::k_off);
  T* sV = reinterpret_cast<T*>(smem + S::v_off);
  float* sS = reinterpret_cast<float*>(smem + S::s_off);
  T* sP = reinterpret_cast<T*>(smem + S::p_off);
  float* sO = reinterpret_cast<float*>(smem + S::o_off);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // Highest Q tiles first: under causal masking they carry the most
  // K tiles, so the long blocks start early and the short ones fill in.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = qt * BQ;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const uint8_t* mrow = kv_mask ? kv_mask + (long long)b * Tk : nullptr;

  load_tile<T, D>(sQ, qb, q_st, q0, Tq, tid);
  for (int i = tid; i < BQ * S::LDO; i += NTHREADS) sO[i] = 0.f;

  // The softmax and the epilogue give each query row to two lanes:
  // lane pair (2r, 2r+1) of warp w owns row w*16 + r, one half of its
  // columns each.
  const int r = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int q_pos = q0 + r;
  float m = NEG_INF;
  float l = 0.f;

  int n_kt = (Tk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * S::LDQ + kk * 16, S::LDQ);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(sK, kb, k_st, k0, Tk, tid);
    load_tile<T, D>(sV, vb, v_st, k0, Tk, tid);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (K row-major is K^T col-major).
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sK + n * 16 * S::LDQ + kk * 16, S::LDQ);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(sS + warp * 16 * S::LDS + n * 16, sf, S::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over this lane's 32 columns of row r.
    const bool need_mask =
        (causal && k0 + BK - 1 > q0) || (k0 + BK > Tk) || (mrow != nullptr);
    const float* srow = sS + r * S::LDS + half * 32;
    float s[32];
    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float x = srow[j] * scale;
      if (need_mask) {
        const int kp = k0 + half * 32 + j;
        const bool keep = kp < Tk && (!causal || kp <= q_pos) &&
                          (mrow == nullptr || mrow[kp] != 0);
        if (!keep) x = NEG_INF;
      }
      s[j] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float m_use = safe_max(m_new);
    const float alpha = expf(safe_max(m) - m_use);
    T* prow = sP + r * S::LDP + half * 32;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = expf(s[j] - m_use);
      psum += p;
      prow[j] = from_float<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    float* orow = sO + r * S::LDO + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) orow[j] *= alpha;
    __syncwarp();

    // O += P V
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, sO + warp * 16 * S::LDO + n * 16, S::LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, sP + warp * 16 * S::LDP + kk * 16, S::LDP);
        wmma::load_matrix_sync(vf, sV + kk * 16 * S::LDQ + n * 16, S::LDQ);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(sO + warp * 16 * S::LDO + n * 16, of, S::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (q_pos < Tq) {
    const float l_safe = fmaxf(l, 1e-30f);
    const float* orow = sO + r * S::LDO + half * (D / 2);
    T* og = o + ((long long)(b * Tq + q_pos) * H + h) * D + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) og[j] = from_float<T>(orow[j] / l_safe);
    if (half == 0) lse[(long long)bh * Tq + q_pos] = safe_max(m) + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_mask, void* o, float* lse, int B, int H,
                   int Tq, int Tk, const long long* qs, const long long* ks,
                   const long long* vs, float scale, int causal,
                   cudaStream_t stream) {
  using S = Smem<D>;
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::total);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kern<<<grid, NTHREADS, S::total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<T*>(o), lse, H, Tq, Tk, qs[0], qs[1], qs[2], ks[0], ks[1],
      ks[2], vs[0], vs[1], vs[2], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* kv_mask, void* o, float* lse, int B, int H,
                       int Tq, int Tk, const long long* qs, const long long* ks,
                       const long long* vs, float scale, int causal,
                       cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, kv_mask, o, lse, B, H, Tq, Tk, qs, ks, vs,
                           scale, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, kv_mask, o, lse, B, H, Tq, Tk, qs, ks, vs,
                           scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, kv_mask, o, lse, B, H, Tq, Tk, qs, ks, vs,
                           scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, kv_mask, o, lse, B, H, Tq, Tk, qs, ks, vs,
                            scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (loaded with ctypes).  dtype: 0 = bf16, 1 = f16.
// *_strides: {batch, sequence, head} strides of q/k/v in elements (the
// last dim is contiguous).  kv_mask: [B, Tk] bytes, 0 = masked, or NULL.
// Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int edl_flash_fwd(int dtype, const void* q, const void* k,
                             const void* v, const void* kv_mask, void* o,
                             float* lse, int B, int H, int Tq, int Tk, int D,
                             const long long* q_strides,
                             const long long* k_strides,
                             const long long* v_strides, float scale,
                             int causal, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)dispatch_d<__nv_bfloat16>(D, q, k, v, kv_mask, o, lse, B, H,
                                          Tq, Tk, q_strides, k_strides,
                                          v_strides, scale, causal, st);
  }
  if (dtype == 1) {
    return (int)dispatch_d<__half>(D, q, k, v, kv_mask, o, lse, B, H, Tq, Tk,
                                   q_strides, k_strides, v_strides, scale,
                                   causal, st);
  }
  return (int)cudaErrorInvalidValue;
}
