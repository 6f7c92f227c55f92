// Tile helpers of the merged flash-attention backward for Hopper
// (sm_90a), flash_bwd.cu (B2): WMMA tiles staged through shared memory,
// and (from flash_bwd_delta.cuh) its delta pass.  Nothing here has
// external linkage.
//
// - Smem<D>: the shared-memory layout of one block (Q, dO, K, V tiles of
//   64 rows, S and dP in f32, P and dS in the input type);
// - load_tile: stage 64 rows of a strided [B, T, H, D] operand;
// - score_tiles: S = Q K^T and dP = dO V^T for a warp's 16 query rows;
// - probs_row: P = exp(scale * S - lse) and dS = P * (dP - delta) for
//   one row, masked keys giving exactly 0;
// - write_rows: a warp's 16 accumulator rows, cast, into [B, T, H, D];
// - Args: the operands and strides the kernels read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "flash_bwd_delta.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64;  // query rows per tile: 4 warps x 16 rows
constexpr int BK = 64;  // keys per tile: 4 warps x 16 keys
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

// Shared-memory layout of every backward kernel's block.  Rows
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

}  // namespace
