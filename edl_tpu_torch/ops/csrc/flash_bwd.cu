// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of
// O = softmax(scale * Q K^T) V from the forward's O and per-row
// logsumexp, causal or with a [B, Tk] key mask, without the [T, T]
// score or probability matrix ever reaching device memory.
//
// Replaces the TPU kernel edl_tpu/ops/flash_attention.py::_bwd_kernel
// (the merged backward launched by _flash_bwd_3d).  Same function:
// P = exp(scale * Q K^T - lse) recomputed per tile (masked keys give
// exactly 0), delta = rowsum(dO * O) - g_lse, dS = P * (dP - delta)
// with dP = dO V^T, dS cast to the input type before the dK and dQ
// products and P before the dV product, f32 accumulation, and dQ, dK
// multiplied by scale after accumulation.
//
// The TPU kernel keeps K/V and a full-T f32 dK/dV scratch resident per
// (batch*head) while Q tiles stream through a sequential grid: at
// T=2048, D=64 that scratch alone is 1 MB, far above a Hopper block's
// 227 KB, and Hopper blocks run in parallel with nothing carried
// between them.  So the work is split into three launches, none of
// which uses atomics (the result is bit-identical run to run):
//
// 1. delta: one pass over O and dO, a few lanes per row, f32.
// 2. dK/dV: one block (4 warps) per (batch*head, 64-key tile).  The
//    K and V tiles stay in shared memory; the block sweeps the 64-row
//    Q tiles from the causal diagonal on, and each warp keeps the f32
//    dK and dV of its 16 keys in WMMA accumulator registers, written
//    once at the end.
// 3. dQ: one block per (batch*head, 64-row Q tile), sweeping the K
//    tiles up to the diagonal, dQ in registers, written once.
//
// The score products S = Q K^T and dP = dO V^T are computed in both (2)
// and (3): seven tile products instead of the merged kernel's five,
// the price of no atomics and no dQ partials (B3's per-K-block dQ
// partials would be a [B*H, T/64, T, D] f32 buffer: 1.6 GB at B=8).
//
// Bound on the H100 at the training shape (B=8, T=2048, H=12, D=64,
// causal): the five products of the function, 10*B*H*D*T*(T+1)/2 =
// 1.29e11 FLOP, 0.13 ms at 989 TFLOP/s dense bf16, against about
// 0.2 GB of Q/K/V/O/dO/dQ/dK/dV/lse, 0.06 ms at 3.35 TB/s —
// compute-bound.  This first version (WMMA 16x16x16, S/dP/P/dS round
// trips through shared memory, synchronous loads, no TMA or wgmma) is
// built to be right; its measured time is in PERF.md.
//
// Ragged T: Q rows and keys past the sequence end are zero-filled and
// masked, as in flash_fwd.cu.  Q, K, V and dO are read in place from
// [B, T, H, D] with arbitrary batch/sequence/head strides (the slices
// of a fused QKV projection need no copy); dQ, dK, dV are written
// contiguous [B, T, H, D]; lse, g_lse and delta are [B*H, Tq] f32.

#include "flash_bwd_tiles.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       const float* __restrict__ glse,
                       float* __restrict__ delta, int B, int H, int Tq,
                       long long o_sb, long long o_st, long long o_sh,
                       long long d_sb, long long d_st, long long d_sh) {
  delta_rows<T, D>(o, dout, glse, delta, B, H, Tq, o_sb, o_st, o_sh, d_sb,
                   d_st, d_sh);
}

// dK and dV of one (batch*head, 64-key tile).
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkdv_kernel(Args a) {
  using S = Smem<D>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + S::q_off);
  T* sDO = reinterpret_cast<T*>(smem + S::do_off);
  T* sK = reinterpret_cast<T*>(smem + S::k_off);
  T* sV = reinterpret_cast<T*>(smem + S::v_off);
  float* sS = reinterpret_cast<float*>(smem + S::s_off);
  float* sDP = reinterpret_cast<float*>(smem + S::dp_off);
  T* sP = reinterpret_cast<T*>(smem + S::p_off);
  T* sDS = reinterpret_cast<T*>(smem + S::ds_off);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // Low K tiles first: under causal masking they sweep the most Q tiles.
  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int k0 = kt * BK;

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* db = static_cast<const T*>(a.dout) + b * a.d_sb + h * a.d_sh;
  const float* lse_bh = a.lse + (long long)bh * a.Tq;
  const float* delta_bh = a.delta + (long long)bh * a.Tq;
  const uint8_t* mrow = a.kv_mask ? a.kv_mask + (long long)b * a.Tk : nullptr;

  load_tile<T, D>(sK, kb, a.k_st, k0, a.Tk, tid);
  load_tile<T, D>(sV, vb, a.v_st, k0, a.Tk, tid);

  Acc dk[D / 16], dv[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk[n], 0.f);
    wmma::fill_fragment(dv[n], 0.f);
  }

  const int r = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int n_qt = (a.Tq + BQ - 1) / BQ;
  // BQ == BK: the first Q tile holding a row at or past key k0.
  const int qt0 = a.causal ? kt : 0;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // every warp is done with the previous Q tile
    load_tile<T, D>(sQ, qb, a.q_st, q0, a.Tq, tid);
    load_tile<T, D>(sDO, db, a.d_st, q0, a.Tq, tid);
    __syncthreads();

    score_tiles<T, D>(sQ, sK, sDO, sV, sS, sDP, warp);
    __syncwarp();

    const int q_pos = q0 + r;
    const bool in_range = q_pos < a.Tq;
    const float lse_r = in_range ? lse_bh[q_pos] : 0.f;
    const float delta_r = in_range ? delta_bh[q_pos] : 0.f;
    const bool need_mask = (a.causal && k0 + BK - 1 > q0) || (k0 + BK > a.Tk) ||
                           (q0 + BQ > a.Tq) || (mrow != nullptr);
    probs_row<T, D>(sS, sDP, sP, sDS, r, half, q_pos, k0, lse_r, delta_r,
                    a.scale, need_mask, a.causal, a.Tq, a.Tk, mrow, true);
    __syncthreads();  // P and dS of all 64 query rows are in place

    // dV += P^T dO and dK += dS^T Q for this warp's 16 keys.  P stored
    // row-major [q][k] read column-major is P^T.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> pt, dst;
      wmma::load_matrix_sync(pt, sP + kk * 16 * S::LDP + warp * 16, S::LDP);
      wmma::load_matrix_sync(dst, sDS + kk * 16 * S::LDP + warp * 16, S::LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> df, qf;
        wmma::load_matrix_sync(df, sDO + kk * 16 * S::LDQ + n * 16, S::LDQ);
        wmma::mma_sync(dv[n], pt, df, dv[n]);
        wmma::load_matrix_sync(qf, sQ + kk * 16 * S::LDQ + n * 16, S::LDQ);
        wmma::mma_sync(dk[n], dst, qf, dk[n]);
      }
    }
  }

  __syncthreads();  // S/dP become the output staging area
  float* staging = sS;
  write_rows<T, D>(dk, a.scale, staging, static_cast<T*>(a.dk), b, h, a.H,
                   a.Tk, k0, a.Tk, warp, lane);
  write_rows<T, D>(dv, 1.f, staging, static_cast<T*>(a.dv), b, h, a.H, a.Tk,
                   k0, a.Tk, warp, lane);
}

// dQ of one (batch*head, 64-row Q tile).
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(Args a) {
  using S = Smem<D>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + S::q_off);
  T* sDO = reinterpret_cast<T*>(smem + S::do_off);
  T* sK = reinterpret_cast<T*>(smem + S::k_off);
  T* sV = reinterpret_cast<T*>(smem + S::v_off);
  float* sS = reinterpret_cast<float*>(smem + S::s_off);
  float* sDP = reinterpret_cast<float*>(smem + S::dp_off);
  T* sP = reinterpret_cast<T*>(smem + S::p_off);
  T* sDS = reinterpret_cast<T*>(smem + S::ds_off);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // Highest Q tiles first: under causal masking they sweep the most K
  // tiles, so the long blocks start early.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = qt * BQ;

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* db = static_cast<const T*>(a.dout) + b * a.d_sb + h * a.d_sh;
  const uint8_t* mrow = a.kv_mask ? a.kv_mask + (long long)b * a.Tk : nullptr;

  load_tile<T, D>(sQ, qb, a.q_st, q0, a.Tq, tid);
  load_tile<T, D>(sDO, db, a.d_st, q0, a.Tq, tid);

  const int r = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int q_pos = q0 + r;
  const bool in_range = q_pos < a.Tq;
  const float lse_r = in_range ? a.lse[(long long)bh * a.Tq + q_pos] : 0.f;
  const float delta_r = in_range ? a.delta[(long long)bh * a.Tq + q_pos] : 0.f;

  Acc dq[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq[n], 0.f);

  int n_kt = (a.Tk + BK - 1) / BK;
  if (a.causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(sK, kb, a.k_st, k0, a.Tk, tid);
    load_tile<T, D>(sV, vb, a.v_st, k0, a.Tk, tid);
    __syncthreads();

    score_tiles<T, D>(sQ, sK, sDO, sV, sS, sDP, warp);
    __syncwarp();
    const bool need_mask = (a.causal && k0 + BK - 1 > q0) || (k0 + BK > a.Tk) ||
                           (q0 + BQ > a.Tq) || (mrow != nullptr);
    probs_row<T, D>(sS, sDP, sP, sDS, r, half, q_pos, k0, lse_r, delta_r,
                    a.scale, need_mask, a.causal, a.Tq, a.Tk, mrow, false);
    __syncwarp();

    // dQ += dS K for this warp's 16 rows.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> dsf;
      wmma::load_matrix_sync(dsf, sDS + warp * 16 * S::LDP + kk * 16, S::LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> kf;
        wmma::load_matrix_sync(kf, sK + kk * 16 * S::LDQ + n * 16, S::LDQ);
        wmma::mma_sync(dq[n], dsf, kf, dq[n]);
      }
    }
  }

  __syncthreads();  // S/dP become the output staging area
  write_rows<T, D>(dq, a.scale, sS, static_cast<T*>(a.dq), b, h, a.H, a.Tq,
                   q0, a.Tq, warp, lane);
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, const void* o, const long long* os,
                   const float* glse, float* delta, cudaStream_t stream) {
  using S = Smem<D>;
  const long long ds[3] = {a.d_sb, a.d_st, a.d_sh};
  cudaError_t err = launch_delta<T, D>(flash_bwd_delta_kernel<T, D>, o, os,
                                       a.dout, ds, glse, delta, B, a.H, a.Tq,
                                       stream);
  if (err != cudaSuccess) return err;
  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  auto dq = flash_bwd_dq_kernel<T, D>;
  err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::total);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)S::total);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((a.Tk + BK - 1) / BK, B * a.H);
  dkdv<<<kv_grid, NTHREADS, S::total, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 q_grid((a.Tq + BQ - 1) / BQ, B * a.H);
  dq<<<q_grid, NTHREADS, S::total, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const Args& a, int B, const void* o,
                       const long long* os, const float* glse, float* delta,
                       cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(a, B, o, os, glse, delta, stream);
    case 32:
      return launch<T, 32>(a, B, o, os, glse, delta, stream);
    case 64:
      return launch<T, 64>(a, B, o, os, glse, delta, stream);
    case 128:
      return launch<T, 128>(a, B, o, os, glse, delta, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (loaded with ctypes).  dtype: 0 = bf16, 1 = f16.
// *_strides: {batch, sequence, head} strides in elements of q/k/v/o/dO
// (the last dim is contiguous).  lse, glse (or NULL) and the delta
// scratch are [B*H, Tq] f32; kv_mask is [B, Tk] bytes, 0 = masked, or
// NULL.  dq/dk/dv are contiguous [B, T, H, D] of the input type.
// Launches the delta, dK/dV and dQ kernels on `stream`, in that order,
// and returns the first cudaError_t.
extern "C" int edl_flash_bwd(int dtype, const void* q, const void* k,
                             const void* v, const void* o, const void* dout,
                             const float* lse, const float* glse,
                             const void* kv_mask, float* delta, void* dq,
                             void* dk, void* dv, int B, int H, int Tq, int Tk,
                             int D, const long long* q_strides,
                             const long long* k_strides,
                             const long long* v_strides,
                             const long long* o_strides,
                             const long long* do_strides, float scale,
                             int causal, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.kv_mask = static_cast<const uint8_t*>(kv_mask);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.q_sb = q_strides[0];
  a.q_st = q_strides[1];
  a.q_sh = q_strides[2];
  a.k_sb = k_strides[0];
  a.k_st = k_strides[1];
  a.k_sh = k_strides[2];
  a.v_sb = v_strides[0];
  a.v_st = v_strides[1];
  a.v_sh = v_strides[2];
  a.d_sb = do_strides[0];
  a.d_st = do_strides[1];
  a.d_sh = do_strides[2];
  a.scale = scale;
  a.causal = causal;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)dispatch_d<__nv_bfloat16>(D, a, B, o, o_strides, glse, delta,
                                          st);
  }
  if (dtype == 1) {
    return (int)dispatch_d<__half>(D, a, B, o, o_strides, glse, delta, st);
  }
  return (int)cudaErrorInvalidValue;
}
