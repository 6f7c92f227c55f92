// Streaming-K flash-attention backward for Hopper (sm_90a): dQ, dK and
// dV of O = softmax(scale * Q K^T) V at long context, in one pass over
// the live (key tile, query tile) pairs, causal or with a [B, Tk] key
// mask, without the [T, T] score matrix ever reaching device memory.
//
// Replaces the TPU kernel edl_tpu/ops/flash_attention.py::
// _bwd_streamk_kernel (launched by _flash_bwd_streamk_3d).  Same
// function as the merged backward (flash_bwd.cu): P = exp(scale * Q K^T
// - lse) with masked keys giving exactly 0, delta = rowsum(dO * O) -
// g_lse precomputed once per row, dS = P * (dP - delta) cast to the
// input type before the dK and dQ products and P before the dV product,
// f32 accumulation.  As in the TPU kernel, the keys are cut into
// *slots* of `slot_w` keys (the TPU kernel's bwd_block_k: 4096 at
// T=32768) and dQ comes out as one f32 partial per slot, summed in slot
// order afterwards.
//
// Work split.  One block (4 warps) per (batch*head, slot, Q chunk) pair
// that the causal mask leaves live; a Q chunk is `chunk_rows` query
// rows (a multiple of 64; the wrapper picks at most 16 chunks).  The
// block walks the slot's 64-key tiles in order; for each it keeps K and
// V in shared memory and sweeps the chunk's 64-row Q tiles from the
// causal diagonal on, with the f32 dK and dV of the tile's 64 keys in
// WMMA accumulator registers:
//
//   S = Q K^T, dP = dO V^T       (2 tile products)
//   dV += P^T dO, dK += dS^T Q   (2)
//   dQpart[slot] += dS K         (1, read-modify-write of the block's
//                                 own f32 partial rows, which each warp
//                                 prefetches into shared memory with
//                                 cp.async when the pair starts)
//
// five tile products per live pair, nothing recomputed.  The dK/dV of
// the key tile go out as f32 partials of the chunk; a reduce pass sums
// the dK/dV partials in chunk order and the dQ partials in slot order
// and casts.  No block writes rows another block writes, and there are
// no atomics: two runs give bit-identical results.  Fully masked causal
// pairs are skipped; the dQ partial rows they would have touched are
// written as 0, and (slot, chunk) pairs with no live key are neither
// launched nor read by the reduce.  At T=32768 with 8 slots and 16
// chunks that is 72 live pairs per batch*head: 864 blocks at B=1, H=12,
// most of them 64 x 32 tile pairs of work, two blocks per SM.
//
// Workspace, allocated by the caller (f32, bytes):
//   dQ partials   B*H * ceil(Tk/slot_w) * round_up(Tq, 64) * D * 4
//   dK, dV partials  2 * B*H * ceil(Tq/chunk_rows) * Tk * D * 4
//   delta         B*H * Tq * 4
// At [1, 32768, 12, 64] with 8 slots and 16 chunks: 0.805 GB + 3.221 GB
// + 1.6 MB = 4.03 GB.  It does not grow with the number of key tiles.
//
// Bound on the H100 at [1, 32768, 12, 64] causal: the five products of
// the function, 10*B*H*D*T*(T+1)/2 = 4.12e12 FLOP, 4.17 ms at 989
// TFLOP/s dense bf16 (the partials' 4 GB of traffic is work of this
// design, not of the function).  This first version (WMMA 16x16x16,
// S/dP/P/dS round trips through shared memory, synchronous tile loads)
// is built to be right; its measured time is in PERF.md.  Loading the
// dQ partial rows where the product needs them, instead of prefetching
// them, made it 2.5x slower there: the partial rows of the 264 resident
// blocks (1 MB each at 8 chunks) miss the L2, and each warp waited on
// the load every pair.
//
// Ragged T and ragged slots: Q rows past Tq, keys past Tk and keys past
// the slot's end are zero-filled and masked, so any T and any slot
// width work.  Q, K, V, O and dO are read in place from [B, T, H, D]
// with arbitrary batch/sequence/head strides; dQ, dK, dV are written
// contiguous [B, T, H, D] of the input type.

#include "flash_bwd_tiles.cuh"

namespace {

constexpr int REDUCE_THREADS = 256;

struct StreamkArgs {
  Args a;             // operands; a.dq/dk/dv are the final outputs
  float* dqp;         // [B*H, n_slots, Tq_pad, D] f32
  float* dkp;         // [B*H, n_chunks, Tk, D] f32
  float* dvp;         // [B*H, n_chunks, Tk, D] f32
  int B, D;
  int slot_w, n_slots, chunk_rows, n_chunks, Tq_pad;

  // Slots with at least one live pair in chunk c: all of them without
  // a causal mask, else those whose first key is at or below the
  // chunk's last row (slots 0 .. live_slots(c) - 1).
  __host__ __device__ int live_slots(int c) const {
    if (!a.causal) return n_slots;
    const int end = (c + 1) * chunk_rows < a.Tq ? (c + 1) * chunk_rows : a.Tq;
    const int live = (end - 1) / slot_w + 1;
    return live < n_slots ? live : n_slots;
  }
  // The first chunk with a live pair in slot j (chunks from it on).
  __host__ __device__ int first_live_chunk(int j) const {
    return a.causal ? (j * slot_w) / chunk_rows : 0;
  }
  __host__ int live_pairs() const {
    int n = 0;
    for (int c = 0; c < n_chunks; ++c) n += live_slots(c);
    return n;
  }
};

// The block's shared memory: the backward tiles of Smem<D>, then one
// f32 [64, D] tile of dQ partial rows (4 warps x 16 rows, each warp's
// rows its own), prefetched with cp.async while the pair's scores are
// computed.
template <int D>
struct StreamkSmem {
  static constexpr int LDF = D + 4;  // dQ partial rows (f32)
  static constexpr size_t dq_off = Smem<D>::total;
  static constexpr size_t total = dq_off + size_t(BQ) * LDF * 4;
};

// 16 bytes global -> shared, asynchronous (sm_80+), cached in L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T, int D>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_bwd_streamk_delta_kernel(const T* __restrict__ o,
                               const T* __restrict__ dout,
                               const float* __restrict__ glse,
                               float* __restrict__ delta, int B, int H,
                               int Tq, long long o_sb, long long o_st,
                               long long o_sh, long long d_sb, long long d_st,
                               long long d_sh) {
  delta_rows<T, D>(o, dout, glse, delta, B, H, Tq, o_sb, o_st, o_sh, d_sb,
                   d_st, d_sh);
}

// Block index -> (slot j, chunk c), the heavier pairs first: for every
// chunk, latest first, its slots below the causal diagonal, then the
// diagonal slot of every chunk (about half the work) last.
__device__ __forceinline__ void pair_of_block(const StreamkArgs& s, int x,
                                              int& j, int& c) {
  const int diag = s.a.causal ? 1 : 0;
  for (int cc = s.n_chunks - 1; cc >= 0; --cc) {
    const int n = s.live_slots(cc) - diag;
    if (x < n) {
      j = x;
      c = cc;
      return;
    }
    x -= n;
  }
  c = s.n_chunks - 1 - x;
  j = s.live_slots(c) - 1;
}

// Write this warp's 16 rows of a [64, D] f32 accumulator into rows
// row0 + warp*16 ... of a row-major [*, D] f32 buffer, through the
// warp's staging rows; rows at or past n_rows are not written.
template <int D>
__device__ __forceinline__ void write_partial_rows(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16],
    float* staging, float* out, int row0, int n_rows, int warp, int lane) {
  using S = Smem<D>;
  float* st = staging + warp * 16 * S::LDO;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(st + n * 16, acc[n], S::LDO, wmma::mem_row_major);
  }
  __syncwarp();
  constexpr int CHUNKS = D / 4;
  for (int i = lane; i < 16 * CHUNKS; i += 32) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 4;
    const int t = row0 + warp * 16 + r;
    if (t >= n_rows) continue;
    *reinterpret_cast<float4*>(out + (long long)t * D + c) =
        *reinterpret_cast<const float4*>(st + r * S::LDO + c);
  }
  __syncwarp();
}

// One (batch*head, slot, Q chunk) pair: the dQ partial rows of the
// chunk for this slot, and the chunk's dK/dV partials of the slot's keys.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_streamk_kernel(StreamkArgs s) {
  using S = Smem<D>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  const Args& a = s.a;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + S::q_off);
  T* sDO = reinterpret_cast<T*>(smem + S::do_off);
  T* sK = reinterpret_cast<T*>(smem + S::k_off);
  T* sV = reinterpret_cast<T*>(smem + S::v_off);
  float* sS = reinterpret_cast<float*>(smem + S::s_off);
  float* sDP = reinterpret_cast<float*>(smem + S::dp_off);
  T* sP = reinterpret_cast<T*>(smem + S::p_off);
  T* sDS = reinterpret_cast<T*>(smem + S::ds_off);
  constexpr int LDF = StreamkSmem<D>::LDF;
  float* sDQ = reinterpret_cast<float*>(smem + StreamkSmem<D>::dq_off);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  int j, c;
  pair_of_block(s, blockIdx.x, j, c);
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;

  const int slot_k0 = j * s.slot_w;
  const int slot_k1 = min(slot_k0 + s.slot_w, a.Tk);
  const int cq0 = c * s.chunk_rows;
  const int cq1 = min(cq0 + s.chunk_rows, a.Tq);
  const int qt_first = cq0 / BQ;
  const int qt_end = (cq1 + BQ - 1) / BQ;

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* db = static_cast<const T*>(a.dout) + b * a.d_sb + h * a.d_sh;
  const float* lse_bh = a.lse + (long long)bh * a.Tq;
  const float* delta_bh = a.delta + (long long)bh * a.Tq;
  const uint8_t* mrow = a.kv_mask ? a.kv_mask + (long long)b * a.Tk : nullptr;
  float* dqp = s.dqp + ((long long)bh * s.n_slots + j) * s.Tq_pad * D;
  float* dkp = s.dkp + ((long long)bh * s.n_chunks + c) * a.Tk * D;
  float* dvp = s.dvp + ((long long)bh * s.n_chunks + c) * a.Tk * D;

  // The first key tile sweeps every Q tile a later one does (the
  // diagonal only moves down), so it stores the dQ partial rows and
  // the later tiles add to them; the chunk's Q tiles above the slot's
  // first key see no key of the slot, and their partial rows are 0.
  const int qt_live0 = a.causal ? max(qt_first, slot_k0 / BQ) : qt_first;
  for (long long i = (long long)qt_first * BQ * D + tid * 4;
       i < (long long)qt_live0 * BQ * D; i += NTHREADS * 4) {
    *reinterpret_cast<float4*>(dqp + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int r = warp * 16 + (lane >> 1);
  const int half = lane & 1;

  for (int k0 = slot_k0; k0 < slot_k1; k0 += BK) {
    const int k_end = min(k0 + BK, slot_k1);
    const bool first_tile = k0 == slot_k0;
    __syncthreads();  // every warp is done with the last K/V tile and staging
    load_tile<T, D>(sK, kb, a.k_st, k0, k_end, tid);
    load_tile<T, D>(sV, vb, a.v_st, k0, k_end, tid);

    Acc dk[D / 16], dv[D / 16];
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fill_fragment(dk[n], 0.f);
      wmma::fill_fragment(dv[n], 0.f);
    }

    // the first Q tile holding a row at or past key k0
    const int qt0 = a.causal ? max(qt_first, k0 / BQ) : qt_first;
    for (int qt = qt0; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      // this warp's 16 dQ partial rows: fetched now (all but the first
      // key tile), added to once this pair's dS is known
      float* dq_rows = dqp + (long long)(q0 + warp * 16) * D;
      float* sdq = sDQ + warp * 16 * LDF;
      if (!first_tile) {
        for (int i = lane; i < 16 * (D / 4); i += 32) {
          const int rr = i / (D / 4);
          const int cc = (i % (D / 4)) * 4;
          cp_async16(sdq + rr * LDF + cc, dq_rows + rr * D + cc);
        }
        cp_async_commit();
      }
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
      const bool need_mask = (a.causal && k0 + BK - 1 > q0) ||
                             (k0 + BK > k_end) || (q0 + BQ > a.Tq) ||
                             (mrow != nullptr);
      probs_row<T, D>(sS, sDP, sP, sDS, r, half, q_pos, k0, lse_r, delta_r,
                      a.scale, need_mask, a.causal, a.Tq, k_end, mrow, true);
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

      // dQpart += dS K for this warp's 16 rows, one 16-column block at a
      // time, read-modify-write of the block's own rows (padded to a
      // multiple of 64, so the ragged last tile stays in the buffer).
      if (!first_tile) {
        cp_async_wait_all();
        __syncwarp();
      }
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        Acc acc;
        if (first_tile) {
          wmma::fill_fragment(acc, 0.f);
        } else {
          wmma::load_matrix_sync(acc, sdq + n * 16, LDF, wmma::mem_row_major);
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> dsf;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> kf;
          wmma::load_matrix_sync(dsf, sDS + warp * 16 * S::LDP + kk * 16, S::LDP);
          wmma::load_matrix_sync(kf, sK + kk * 16 * S::LDQ + n * 16, S::LDQ);
          wmma::mma_sync(acc, dsf, kf, acc);
        }
        wmma::store_matrix_sync(dq_rows + n * 16, acc, D, wmma::mem_row_major);
      }
    }

    __syncthreads();  // S/dP become the staging area of the dK/dV rows
    write_partial_rows<D>(dk, sS, dkp, k0, k_end, warp, lane);
    write_partial_rows<D>(dv, sS, dvp, k0, k_end, warp, lane);
  }
}

// The reduce pass.  mode 0: dq[b, t, h] = scale * sum over the live
// slots of row t's chunk, in slot order.  mode 1: dk = scale * sum and
// dv = sum of the chunk partials of key t over the chunks with a live
// pair in its slot, in chunk order.  D/8 threads per row, rows in
// (b*h, t) order so the partials are read contiguously.
template <typename T, int D>
__global__ void __launch_bounds__(REDUCE_THREADS)
flash_bwd_streamk_reduce_kernel(StreamkArgs s, int mode) {
  constexpr int CH = D / 8;
  const Args& a = s.a;
  const int n_t = mode == 0 ? a.Tq : a.Tk;
  const long long gid = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  const long long row = gid / CH;
  const int part = (int)(gid % CH);
  if (row >= (long long)s.B * a.H * n_t) return;
  const int t = (int)(row % n_t);
  const int bh = (int)(row / n_t);
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  float acc[8], acc2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = acc2[i] = 0.f;
  const long long out_off = ((long long)(b * n_t + t) * a.H + h) * D + part * 8;
  if (mode == 0) {
    const int n = s.live_slots(t / s.chunk_rows);
    const float* p = s.dqp + ((long long)bh * s.n_slots * s.Tq_pad + t) * D + part * 8;
    const long long step = (long long)s.Tq_pad * D;
    for (int jj = 0; jj < n; ++jj) {
      const float4 x0 = *reinterpret_cast<const float4*>(p + jj * step);
      const float4 x1 = *reinterpret_cast<const float4*>(p + jj * step + 4);
      acc[0] += x0.x; acc[1] += x0.y; acc[2] += x0.z; acc[3] += x0.w;
      acc[4] += x1.x; acc[5] += x1.y; acc[6] += x1.z; acc[7] += x1.w;
    }
    alignas(16) T pack[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) pack[i] = from_float<T>(acc[i] * a.scale);
    *reinterpret_cast<uint4*>(static_cast<T*>(a.dq) + out_off) =
        *reinterpret_cast<const uint4*>(pack);
    return;
  }
  const long long base = ((long long)bh * s.n_chunks * a.Tk + t) * D + part * 8;
  const long long step = (long long)a.Tk * D;
  for (int cc = s.first_live_chunk(t / s.slot_w); cc < s.n_chunks; ++cc) {
    const float* pk = s.dkp + base + cc * step;
    const float* pv = s.dvp + base + cc * step;
    const float4 k0 = *reinterpret_cast<const float4*>(pk);
    const float4 k1 = *reinterpret_cast<const float4*>(pk + 4);
    const float4 v0 = *reinterpret_cast<const float4*>(pv);
    const float4 v1 = *reinterpret_cast<const float4*>(pv + 4);
    acc[0] += k0.x; acc[1] += k0.y; acc[2] += k0.z; acc[3] += k0.w;
    acc[4] += k1.x; acc[5] += k1.y; acc[6] += k1.z; acc[7] += k1.w;
    acc2[0] += v0.x; acc2[1] += v0.y; acc2[2] += v0.z; acc2[3] += v0.w;
    acc2[4] += v1.x; acc2[5] += v1.y; acc2[6] += v1.z; acc2[7] += v1.w;
  }
  alignas(16) T pk[8], pv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    pk[i] = from_float<T>(acc[i] * a.scale);
    pv[i] = from_float<T>(acc2[i]);
  }
  *reinterpret_cast<uint4*>(static_cast<T*>(a.dk) + out_off) =
      *reinterpret_cast<const uint4*>(pk);
  *reinterpret_cast<uint4*>(static_cast<T*>(a.dv) + out_off) =
      *reinterpret_cast<const uint4*>(pv);
}

template <typename T, int D>
cudaError_t launch(const StreamkArgs& s, const void* o, const long long* os,
                   const float* glse, float* delta, cudaStream_t stream) {
  using S = StreamkSmem<D>;
  const Args& a = s.a;
  const long long ds[3] = {a.d_sb, a.d_st, a.d_sh};
  cudaError_t err = launch_delta<T, D>(flash_bwd_streamk_delta_kernel<T, D>, o,
                                       os, a.dout, ds, glse, delta, s.B, a.H,
                                       a.Tq, stream);
  if (err != cudaSuccess) return err;
  const int pairs = s.live_pairs();
  if (pairs > 0 && s.B * a.H > 0) {
    auto kern = flash_bwd_streamk_kernel<T, D>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::total);
    if (err != cudaSuccess) return err;
    kern<<<dim3(pairs, s.B * a.H), NTHREADS, S::total, stream>>>(s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  for (int mode = 0; mode < 2; ++mode) {
    const long long rows = (long long)s.B * a.H * (mode == 0 ? a.Tq : a.Tk);
    const long long blocks = (rows * (D / 8) + REDUCE_THREADS - 1) / REDUCE_THREADS;
    if (blocks == 0) continue;
    flash_bwd_streamk_reduce_kernel<T, D>
        <<<(unsigned)blocks, REDUCE_THREADS, 0, stream>>>(s, mode);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch_d(const StreamkArgs& s, const void* o,
                       const long long* os, const float* glse, float* delta,
                       cudaStream_t stream) {
  switch (s.D) {
    case 16:
      return launch<T, 16>(s, o, os, glse, delta, stream);
    case 32:
      return launch<T, 32>(s, o, os, glse, delta, stream);
    case 64:
      return launch<T, 64>(s, o, os, glse, delta, stream);
    case 128:
      return launch<T, 128>(s, o, os, glse, delta, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (loaded with ctypes).  dtype: 0 = bf16, 1 = f16.
// *_strides: {batch, sequence, head} strides in elements of q/k/v/o/dO
// (the last dim is contiguous).  lse, glse (or NULL) and the delta
// scratch are [B*H, Tq] f32; kv_mask is [B, Tk] bytes, 0 = masked, or
// NULL.  slot_w >= 1 keys per dQ partial; chunk_rows, a positive
// multiple of 64, query rows per block.  Workspace (see the header):
// dqp [B*H, ceil(Tk/slot_w), round_up(Tq, 64), D] f32 and dkp, dvp
// [B*H, ceil(Tq/chunk_rows), Tk, D] f32, none of which needs zeroing.
// dq/dk/dv are contiguous [B, T, H, D] of the input type.  Launches the
// delta, pair and two reduce kernels on `stream`, in that order, and
// returns the first cudaError_t.
extern "C" int edl_flash_bwd_streamk(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, const float* glse,
    const void* kv_mask, float* delta, float* dqp, float* dkp, float* dvp,
    void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
    int slot_w, int chunk_rows, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* o_strides, const long long* do_strides, float scale,
    int causal, void* stream) {
  if (slot_w < 1 || chunk_rows < BQ || chunk_rows % BQ != 0) {
    return (int)cudaErrorInvalidValue;
  }
  StreamkArgs s;
  Args& a = s.a;
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
  s.dqp = dqp;
  s.dkp = dkp;
  s.dvp = dvp;
  s.B = B;
  s.D = D;
  s.slot_w = slot_w;
  s.n_slots = (Tk + slot_w - 1) / slot_w;
  s.chunk_rows = chunk_rows;
  s.n_chunks = (Tq + chunk_rows - 1) / chunk_rows;
  s.Tq_pad = (Tq + BQ - 1) / BQ * BQ;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)dispatch_d<__nv_bfloat16>(s, o, o_strides, glse, delta, st);
  }
  if (dtype == 1) {
    return (int)dispatch_d<__half>(s, o, o_strides, glse, delta, st);
  }
  return (int)cudaErrorInvalidValue;
}
