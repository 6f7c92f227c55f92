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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;  // query rows per tile: 4 warps x 16 rows
constexpr int BK = 64;  // keys per tile: 4 warps x 16 keys
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
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

// Shared-memory layout, shared by the dK/dV and the dQ kernels.  Rows
// are padded (8 16-bit or 4 f32 values) so the WMMA tiles of
// consecutive rows fall in different banks; every region and every
// 16-row tile offset stays 32-byte aligned, as load/store_matrix_sync
// require.  The f32 staging of the outputs reuses S and dP.
template <int D>
struct Smem {
  static constexpr int LDQ = D + 8;   // Q, K, V, dO rows (16-bit)
  static constexpr int LDS = BK + 4;  // S, dP rows (f32)
  static constexpr int LDP = BK + 8;  // P, dS rows (16-bit)
  static constexpr int LDO = D + 4;   // output staging rows (f32)
  static constexpr size_t tile_bytes = size_t(64) * LDQ * 2;
  static constexpr size_t s_bytes = size_t(BQ) * LDS * 4;
  static constexpr size_t p_bytes = size_t(BQ) * LDP * 2;
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + tile_bytes;
  static constexpr size_t k_off = do_off + tile_bytes;
  static constexpr size_t v_off = k_off + tile_bytes;
  static constexpr size_t s_off = v_off + tile_bytes;
  static constexpr size_t dp_off = s_off + s_bytes;
  static constexpr size_t p_off = dp_off + s_bytes;
  static constexpr size_t ds_off = p_off + p_bytes;
  static constexpr size_t total = ds_off + p_bytes;
  static_assert(size_t(64) * LDO * 4 <= 2 * s_bytes,
                "output staging must fit in the S and dP regions");
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
  for (int i = tid; i < 64 * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// S = Q K^T and dP = dO V^T for this warp's 16 query rows and all 64
// keys of the tile, f32, into shared memory.  K (and V) row-major is
// K^T (V^T) column-major.
template <typename T, int D>
__device__ __forceinline__ void score_tiles(const T* sQ, const T* sK,
                                            const T* sDO, const T* sV,
                                            float* sS, float* sDP, int warp) {
  using S = Smem<D>;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const T* a_src = pass == 0 ? sQ : sDO;
    const T* b_src = pass == 0 ? sK : sV;
    float* out = pass == 0 ? sS : sDP;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af[D / 16];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(af[kk], a_src + warp * 16 * S::LDQ + kk * 16,
                             S::LDQ);
    }
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bf;
        wmma::load_matrix_sync(bf, b_src + n * 16 * S::LDQ + kk * 16, S::LDQ);
        wmma::mma_sync(acc, af[kk], bf, acc);
      }
      wmma::store_matrix_sync(out + warp * 16 * S::LDS + n * 16, acc, S::LDS,
                              wmma::mem_row_major);
    }
  }
}

// P and dS for one query row, 32 of its keys (the lane pair (2r, 2r+1)
// of a warp owns row r, one half of the columns each).  Masked entries
// and rows past Tq give P = 0 and dS = 0, as exp(NEG_INF - lse) does in
// the TPU kernel.
template <typename T, int D>
__device__ __forceinline__ void probs_row(const float* sS, const float* sDP,
                                          T* sP, T* sDS, int r, int half,
                                          int q_pos, int k0, float lse_r,
                                          float delta_r, float scale,
                                          bool need_mask, int causal, int Tq,
                                          int Tk, const uint8_t* mrow,
                                          bool write_p) {
  using S = Smem<D>;
  const float* srow = sS + r * S::LDS + half * 32;
  const float* dprow = sDP + r * S::LDS + half * 32;
  T* prow = sP + r * S::LDP + half * 32;
  T* dsrow = sDS + r * S::LDP + half * 32;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    bool keep = true;
    if (need_mask) {
      const int kp = k0 + half * 32 + j;
      keep = q_pos < Tq && kp < Tk && (!causal || kp <= q_pos) &&
             (mrow == nullptr || mrow[kp] != 0);
    }
    const float p = keep ? expf(srow[j] * scale - lse_r) : 0.f;
    const float ds = p * (dprow[j] - delta_r);
    if (write_p) prow[j] = from_float<T>(p);
    dsrow[j] = from_float<T>(ds);
  }
}

// Write this warp's 16 rows of a [64, D] f32 result (WMMA accumulators,
// times `mul`) as T into rows row0 + warp*16 ... of a contiguous
// [B, T, H, D] tensor; rows at or past n_rows are not written.
template <typename T, int D>
__device__ __forceinline__ void write_rows(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16],
    float mul, float* staging, T* out, int b, int h, int H, int T_len,
    int row0, int n_rows, int warp, int lane) {
  using S = Smem<D>;
  float* st = staging + warp * 16 * S::LDO;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int i = 0; i < acc[n].num_elements; ++i) acc[n].x[i] *= mul;
    wmma::store_matrix_sync(st + n * 16, acc[n], S::LDO, wmma::mem_row_major);
  }
  __syncwarp();
  constexpr int CHUNKS = D / 8;
  for (int i = lane; i < 16 * CHUNKS; i += 32) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const int t = row0 + warp * 16 + r;
    if (t >= n_rows) continue;
    alignas(16) T pack[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) pack[j] = from_float<T>(st[r * S::LDO + c + j]);
    *reinterpret_cast<uint4*>(out + ((long long)(b * T_len + t) * H + h) * D + c) =
        *reinterpret_cast<const uint4*>(pack);
  }
  __syncwarp();
}

// delta[b*H + h, t] = sum_d dO * O (f32) - g_lse.  D/8 lanes per row,
// 16 bytes each, reduced by shuffles; rows in (b, t, h) order so the
// reads of a warp are contiguous.
template <typename T, int D>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       const float* __restrict__ glse,
                       float* __restrict__ delta, int B, int H, int Tq,
                       long long o_sb, long long o_st, long long o_sh,
                       long long d_sb, long long d_st, long long d_sh) {
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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const uint8_t* kv_mask;
  void* dq;
  void* dk;
  void* dv;
  int H, Tq, Tk;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long d_sb, d_st, d_sh;
  float scale;
  int causal;
};

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
  const long long rows = (long long)B * a.Tq * a.H;
  const long long threads = rows * (D / 8);
  const unsigned delta_blocks =
      (unsigned)((threads + DELTA_THREADS - 1) / DELTA_THREADS);
  if (delta_blocks > 0) {
    flash_bwd_delta_kernel<T, D><<<delta_blocks, DELTA_THREADS, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(a.dout), glse, delta, B,
        a.H, a.Tq, os[0], os[1], os[2], a.d_sb, a.d_st, a.d_sh);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  auto dq = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
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
