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
// *slots* of `slot_w` keys (4096 at T=32768) and dQ comes out as one f32
// partial per slot, summed in slot order afterwards.
//
// Work split.  One block per (batch*head, slot, Q chunk) pair that the
// causal mask leaves live; a Q chunk is `chunk_rows` query rows (a
// multiple of 64; the wrapper picks at most 8 chunks).  The block walks
// the slot's 128-key tiles in order.  Two consumer warpgroups hold 64
// keys each, with their f32 dK and dV in registers across the sweep of
// the chunk's 64-row Q tiles from the causal diagonal on; a producer
// warp streams Q, dO (TMA) and lse, delta through a 2-stage mbarrier
// ring, and K, V of the key tile (TMA) once per tile.  Per (key tile,
// Q tile) pair, all wgmma with f32 accumulators in registers:
//
//   S^T = K Q^T, dP^T = V dO^T   (A = K, V; B = Q, dO: shared, K-major)
//   P^T, dS^T in registers, cast to the input type
//   dV += P^T dO, dK += dS^T Q   (A = P^T, dS^T from registers; B = dO,
//                                 Q through the transpose bit)
//   dQpart[slot] += dS K         (dS^T stored once to shared memory, A
//                                 through the transpose bit; B = K; all
//                                 128 keys in one product)
//
// five products per pair, nothing recomputed.  The two warpgroups take
// the dQ product of alternate Q tiles; its f32 partial rows are loaded
// into registers when the pair starts (latency hidden behind the other
// four products), added to the product's fresh accumulator and stored
// when it ends, read-modify-write by their one owner.  (Loading them
// into the accumulator itself made ptxas serialize the wgmma pipeline,
// which ran measurably slower on the H100.)  The dK/dV of the key tile go out as f32 partials of
// the chunk; a reduce pass sums the dK/dV partials in chunk order and
// the dQ partials in slot order and casts.  No block writes rows another
// block writes, and there are no atomics: two runs give bit-identical
// results.  Fully masked causal pairs are skipped; the dQ partial rows
// they would have touched are written as 0, and (slot, chunk) pairs with
// no live key are neither launched nor read by the reduce.
//
// What bounds it on the H100.  The function at [1, 32768, 12, 64]
// causal is its five products, 10*B*H*D*T*(T+1)/2 = 4.12e12 FLOP, 4.17
// ms at 989 TFLOP/s dense bf16.  The design adds the dQ partial
// traffic: every live (128-key tile, 64-row Q tile) pair reads and
// writes 64 x D f32 partial rows (32 KB at D = 64; the first key tile
// of a slot only writes them).  There, with 8 slots of 4096 keys and 8
// chunks of 4096 rows, 789,504 live pairs move 25.4 GB, 7.6 ms at 3.35
// TB/s if every row missed the 50 MB L2 (the 64-key tiles of the first
// version moved twice that).  The key
// tile width is the lever: each dQ update covers all 128 keys of the
// block.
//
// Workspace, allocated by the caller (f32, bytes):
//   dQ partials   B*H * ceil(Tk/slot_w) * round_up(Tq, 64) * D * 4
//   dK, dV partials  2 * B*H * ceil(Tq/chunk_rows) * Tk * D * 4
//   delta         B*H * Tq * 4
// At [1, 32768, 12, 64] with 8 slots and 8 chunks: 0.805 GB + 1.611 GB
// + 1.6 MB = 2.42 GB, 432 blocks of 36 live pairs per batch*head
// (streamk_geometry in ops/flash_attention.py computes these).
//
// Ragged T and ragged slots: TMA reads zeros past the sequence's end;
// Q rows past Tq, keys past Tk and keys past the slot's end are masked,
// so any T and any slot width work.  Q, K, V, O and dO are read in place
// from [B, T, H, D] with arbitrary batch/sequence/head strides; dQ, dK,
// dV are written contiguous [B, T, H, D] of the input type.

#include "flash_bwd_delta.cuh"
#include "hopper.cuh"

namespace {

constexpr int BKT = 128;  // keys per key tile: 2 consumer warpgroups x 64
constexpr int BQ = 64;    // query rows per Q tile
constexpr int CONSUMERS = 2;
constexpr int NTHREADS = 128 * (CONSUMERS + 1);
constexpr int REDUCE_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory layout: K and V tiles of the key tile, two Q stages (Q,
// dO, lse * log2(e), delta of 64 rows), two dS^T buffers ([128 keys, 64
// rows], 128-byte rows), the barriers.  Tiles are D / PW panels of
// [rows, PW] (hopper.cuh); every region is 1024-byte aligned.
template <int D>
struct Layout {
  static constexpr int PW = D < 64 ? D : 64;
  static constexpr int NP = D / PW;
  static constexpr int ROW_BYTES = PW * 2;
  static constexpr int KPP = PW / 16;
  static constexpr size_t k_panel = size_t(BKT) * ROW_BYTES;
  static constexpr size_t q_panel = size_t(BQ) * ROW_BYTES;
  static constexpr size_t k_bytes = k_panel * NP;  // one K or V tile
  static constexpr size_t q_bytes = q_panel * NP;  // one Q or dO tile
  static constexpr size_t v_off = k_bytes;
  static constexpr size_t stage_off = 2 * k_bytes;
  static constexpr size_t stats_off = 2 * q_bytes;  // within a stage
  static constexpr size_t stage_bytes = (2 * q_bytes + 2 * BQ * 4 + 1023) / 1024 * 1024;
  static constexpr size_t ds_off = stage_off + 2 * stage_bytes;
  static constexpr size_t ds_bytes = size_t(BKT) * BQ * 2;
  static constexpr size_t bar_off = ds_off + 2 * ds_bytes;
  // 6 barriers, and slack to align the dynamic buffer to 1024 bytes
  static constexpr size_t total = bar_off + 64 + 1024;
};

struct StreamkArgs {
  const float* lse;        // [B*H, Tq]
  const float* delta;      // [B*H, Tq]
  const uint8_t* kv_mask;  // [B, Tk] or null
  float* dqp;              // [B*H, n_slots, Tq_pad, D] f32
  float* dkp;              // [B*H, n_chunks, Tk, D] f32
  float* dvp;              // [B*H, n_chunks, Tk, D] f32
  void* dq;                // [B, Tq, H, D]
  void* dk;                // [B, Tk, H, D]
  void* dv;                // [B, Tk, H, D]
  int B, H, Tq, Tk, D;
  int slot_w, n_slots, chunk_rows, n_chunks, Tq_pad;
  float scale;
  int causal;

  // Slots with at least one live pair in chunk c: all of them without
  // a causal mask, else those whose first key is at or below the
  // chunk's last row (slots 0 .. live_slots(c) - 1).
  __host__ __device__ int live_slots(int c) const {
    if (!causal) return n_slots;
    const int end = (c + 1) * chunk_rows < Tq ? (c + 1) * chunk_rows : Tq;
    const int live = (end - 1) / slot_w + 1;
    return live < n_slots ? live : n_slots;
  }
  // The first chunk with a live pair in slot j (chunks from it on).
  __host__ __device__ int first_live_chunk(int j) const {
    return causal ? (j * slot_w) / chunk_rows : 0;
  }
  __host__ int live_pairs() const {
    int n = 0;
    for (int c = 0; c < n_chunks; ++c) n += live_slots(c);
    return n;
  }
};

// The delta pass (flash_bwd_delta.cuh), under this file's own name so
// a profile tells B3's from B2's.
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
  const int diag = s.causal ? 1 : 0;
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

// One (batch*head, slot, Q chunk) pair: the dQ partial rows of the
// chunk for this slot, and the chunk's dK/dV partials of the slot's keys.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_streamk_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const StreamkArgs s) {
  using L = Layout<D>;
  constexpr int PW = L::PW;
  constexpr int NP = L::NP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + 1;
  uint64_t* q_full = bars + 2;   // [2]
  uint64_t* q_empty = bars + 4;  // [2]
  const unsigned char* sk = smem;
  const unsigned char* sv = smem + L::v_off;

  // warp-uniform to the compiler (a shuffle from lane 0), so branches on
  // it hold no wgmma in a divergent path
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int bh = blockIdx.x;
  const int b = bh / s.H;
  const int h = bh - b * s.H;
  int j, c;
  pair_of_block(s, blockIdx.y, j, c);

  const int slot_k0 = j * s.slot_w;
  const int slot_k1 = min(slot_k0 + s.slot_w, s.Tk);
  const int n_kt = (slot_k1 - slot_k0 + BKT - 1) / BKT;
  const int cq0 = c * s.chunk_rows;
  const int cq1 = min(cq0 + s.chunk_rows, s.Tq);
  const int qt_first = cq0 / BQ;
  const int qt_end = (cq1 + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, CONSUMERS * 128);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 32);  // the producer warp's lanes
      mbar_init(&q_empty[i], CONSUMERS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: warp 0 of the last warpgroup ----
    setmaxnreg_dec<40>();
    if (tid < 32) {
      const int lane = tid;
      const float* lse_bh = s.lse + (long long)bh * s.Tq;
      const float* delta_bh = s.delta + (long long)bh * s.Tq;
      int it = 0;
      for (int t = 0; t < n_kt; ++t) {
        const int k0 = slot_k0 + t * BKT;
        if (t > 0) mbar_wait(kv_empty, (t - 1) & 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(kv_full, (uint32_t)(2 * L::k_bytes));
          for (int p = 0; p < NP; ++p) {
            tma_load_4d(smem + p * L::k_panel, &tm_k, kv_full, p * PW, h, k0, b);
            tma_load_4d(smem + L::v_off + p * L::k_panel, &tm_v, kv_full, p * PW, h,
                        k0, b);
          }
        }
        const int qt0 = s.causal ? max(qt_first, k0 / BQ) : qt_first;
        for (int qt = qt0; qt < qt_end; ++qt, ++it) {
          const int st = it & 1;
          const int r = it >> 1;
          if (r > 0) mbar_wait(&q_empty[st], (r - 1) & 1);
          unsigned char* stage = smem + L::stage_off + st * L::stage_bytes;
          float* stats = reinterpret_cast<float*>(stage + L::stats_off);
          const int q0 = qt * BQ;
#pragma unroll
          for (int rr = lane; rr < BQ; rr += 32) {
            const int q = q0 + rr;
            stats[rr] = q < s.Tq ? lse_bh[q] * LOG2E : 0.f;
            stats[BQ + rr] = q < s.Tq ? delta_bh[q] : 0.f;
          }
          if (lane == 0) {
            mbar_arrive_expect_tx(&q_full[st], (uint32_t)(2 * L::q_bytes));
            for (int p = 0; p < NP; ++p) {
              tma_load_4d(stage + p * L::q_panel, &tm_q, &q_full[st], p * PW, h, q0, b);
              tma_load_4d(stage + L::q_bytes + p * L::q_panel, &tm_do, &q_full[st],
                          p * PW, h, q0, b);
            }
          } else {
            mbar_arrive(&q_full[st]);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 keys per warpgroup ----
    setmaxnreg_inc<232>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int cc = lane % 4;
    const uint8_t* mrow = s.kv_mask ? s.kv_mask + (long long)b * s.Tk : nullptr;
    float* dqp = s.dqp + ((long long)bh * s.n_slots + j) * s.Tq_pad * D;
    float* dkp = s.dkp + ((long long)bh * s.n_chunks + c) * s.Tk * D;
    float* dvp = s.dvp + ((long long)bh * s.n_chunks + c) * s.Tk * D;
    const float scale_log2 = s.scale * LOG2E;

    // The first key tile sweeps every Q tile a later one does (the
    // diagonal only moves down), so it stores the dQ partial rows and
    // the later tiles add to them; the chunk's Q tiles above the slot's
    // first key see no key of the slot, and their partial rows are 0.
    const int qt_live0 = s.causal ? max(qt_first, slot_k0 / BQ) : qt_first;
    for (long long i = (long long)qt_first * BQ * D + threadIdx.x * 4;
         i < (long long)qt_live0 * BQ * D; i += CONSUMERS * 128 * 4) {
      *reinterpret_cast<float4*>(dqp + i) = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    int it = 0;
    for (int t = 0; t < n_kt; ++t) {
      const int k0 = slot_k0 + t * BKT;
      const int kw0 = k0 + 64 * wg;  // this warpgroup's first key
      const int key0 = kw0 + 16 * warp + g;  // this thread's keys: key0, key0 + 8
      const unsigned char* skw = sk + 64 * wg * L::ROW_BYTES;
      const unsigned char* svw = sv + 64 * wg * L::ROW_BYTES;
      float dk[NP][PW / 2], dv[NP][PW / 2];
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < PW / 2; ++i) dk[p][i] = dv[p][i] = 0.f;
      mbar_wait(kv_full, t & 1);

      const int qt0 = s.causal ? max(qt_first, k0 / BQ) : qt_first;
      for (int qt = qt0; qt < qt_end; ++qt, ++it) {
        const int st = it & 1;
        const int q0 = qt * BQ;
        const bool owner = ((qt - qt0) & 1) == wg;  // takes this tile's dQ product
        const unsigned char* sq = smem + L::stage_off + st * L::stage_bytes;
        const unsigned char* sdo = sq + L::q_bytes;
        const float* stats = reinterpret_cast<const float*>(sq + L::stats_off);
        unsigned char* sds = smem + L::ds_off + ((qt - qt0) & 1) * L::ds_bytes;

        // this tile's dQ partial rows, fetched now and added to dS K once
        // dS is known (row 16 warp + g + 8 i, column p PW + 8 n + 2 cc + j)
        float dq[NP][PW / 2], dq_prev[NP][PW / 2];
        float* dq_rows = dqp + (long long)(q0 + 16 * warp + g) * D + 2 * cc;
        if (owner) {
#pragma unroll
          for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int n = 0; n < PW / 8; ++n)
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                float2 x = make_float2(0.f, 0.f);
                if (t > 0) {
                  x = *reinterpret_cast<const float2*>(dq_rows + 8 * i * D + p * PW + 8 * n);
                }
                dq_prev[p][4 * n + 2 * i] = x.x;
                dq_prev[p][4 * n + 2 * i + 1] = x.y;
              }
        }

        // S^T = K Q^T and dP^T = V dO^T: rows = this warpgroup's keys,
        // columns = the tile's 64 query rows
        float sacc[BQ / 2], dpacc[BQ / 2];
        mbar_wait(&q_full[st], (it >> 1) & 1);
        fence_operand(sacc);
        fence_operand(dpacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int p = kk / L::KPP;
          const int koff = (kk % L::KPP) * 32;
          wgmma_ss<T, 0, 0>(sacc, smem_desc(skw + p * L::k_panel + koff, L::ROW_BYTES),
                            smem_desc(sq + p * L::q_panel + koff, L::ROW_BYTES), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int p = kk / L::KPP;
          const int koff = (kk % L::KPP) * 32;
          wgmma_ss<T, 0, 0>(dpacc, smem_desc(svw + p * L::k_panel + koff, L::ROW_BYTES),
                            smem_desc(sdo + p * L::q_panel + koff, L::ROW_BYTES), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(sacc);
        fence_operand(dpacc);

        // P^T and dS^T on the fragment: element [4n + 2i + jj] is key
        // key0 + 8i, query row q0 + 8n + 2cc + jj.  Masked pairs and
        // rows past Tq give P = 0 and dS = 0.
        const int k_end = slot_k1;
        const bool need_mask = (s.causal && kw0 + 63 > q0) || (kw0 + 64 > k_end) ||
                               (q0 + BQ > s.Tq) || (mrow != nullptr);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int col = 8 * n + 2 * cc + jj;
            const float lse2 = stats[col];
            const float dlt = stats[BQ + col];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int e = 4 * n + 2 * i + jj;
              bool keep = true;
              if (need_mask) {
                const int kp = key0 + 8 * i;
                const int qp = q0 + col;
                keep = qp < s.Tq && kp < k_end && (!s.causal || kp <= qp) &&
                       (mrow == nullptr || mrow[kp] != 0);
              }
              const float pv = keep ? exp2f(sacc[e] * scale_log2 - lse2) : 0.f;
              sacc[e] = pv;
              dpacc[e] = pv * (dpacc[e] - dlt);
            }
          }
        }
        // register A fragments (k16 steps over the 64 query rows)
        uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int qd = 0; qd < 4; ++qd) {
            pf[kk][qd] = pack2<T>(sacc[8 * kk + 2 * qd], sacc[8 * kk + 2 * qd + 1]);
            dsf[kk][qd] = pack2<T>(dpacc[8 * kk + 2 * qd], dpacc[8 * kk + 2 * qd + 1]);
          }
        // dS^T into this tile's buffer: key row 64 wg + 16 warp + g + 8i
        // of 128-byte rows (64 query rows), in TMA's 128-byte swizzle
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = 64 * wg + 16 * warp + g + 8 * i;
            *reinterpret_cast<uint32_t*>(sds + row * 128 + ((n ^ (row & 7)) << 4) + 4 * cc) =
                dsf[n / 2][2 * (n % 2) + i];
          }
        fence_proxy_async();

        // dV += P^T dO, dK += dS^T Q
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          fence_operand(dk[p]);
          fence_operand(dv[p]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            wgmma_rs<T, 1>(dv[p], pf[kk],
                           smem_desc(sdo + p * L::q_panel + kk * 16 * L::ROW_BYTES,
                                     L::ROW_BYTES),
                           1);
            wgmma_rs<T, 1>(dk[p], dsf[kk],
                           smem_desc(sq + p * L::q_panel + kk * 16 * L::ROW_BYTES,
                                     L::ROW_BYTES),
                           1);
          }
        wgmma_commit();

        // every dS^T row of this tile is in place: dQ += dS K over the
        // 128 keys (A = dS^T's buffer, MN-major; B = K, MN-major)
        named_barrier_sync(1, CONSUMERS * 128);
        if (owner) {
#pragma unroll
          for (int kk = 0; kk < BKT / 16; ++kk)
#pragma unroll
            for (int p = 0; p < NP; ++p)
              wgmma_ss<T, 1, 1>(dq[p], smem_desc(sds + kk * 16 * 128, 128),
                                smem_desc(sk + p * L::k_panel + kk * 16 * L::ROW_BYTES,
                                          L::ROW_BYTES),
                                kk > 0);
          wgmma_commit();
        }
        wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          fence_operand(dk[p]);
          fence_operand(dv[p]);
        }
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          fence_operand(pf[kk]);
          fence_operand(dsf[kk]);
        }
        mbar_arrive(&q_empty[st]);
        if (owner) {
#pragma unroll
          for (int p = 0; p < NP; ++p) fence_operand(dq[p]);
#pragma unroll
          for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int n = 0; n < PW / 8; ++n)
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                *reinterpret_cast<float2*>(dq_rows + 8 * i * D + p * PW + 8 * n) =
                    make_float2(dq[p][4 * n + 2 * i] + dq_prev[p][4 * n + 2 * i],
                                dq[p][4 * n + 2 * i + 1] + dq_prev[p][4 * n + 2 * i + 1]);
              }
        }
      }

      // the key tile's dK/dV partial rows of this chunk
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = key0 + 8 * i;
        if (key >= slot_k1) continue;
        float* krow = dkp + (long long)key * D + 2 * cc;
        float* vrow = dvp + (long long)key * D + 2 * cc;
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int n = 0; n < PW / 8; ++n) {
            *reinterpret_cast<float2*>(krow + p * PW + 8 * n) =
                make_float2(dk[p][4 * n + 2 * i], dk[p][4 * n + 2 * i + 1]);
            *reinterpret_cast<float2*>(vrow + p * PW + 8 * n) =
                make_float2(dv[p][4 * n + 2 * i], dv[p][4 * n + 2 * i + 1]);
          }
      }
      mbar_arrive(kv_empty);
    }
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
  const StreamkArgs& a = s;
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
cudaError_t launch(const StreamkArgs& s, int dtype, const void* q, const void* k,
                   const void* v, const void* o, const void* dout,
                   const long long* qs, const long long* ks, const long long* vs,
                   const long long* os, const long long* ds, const float* glse,
                   float* delta, cudaStream_t stream) {
  using L = Layout<D>;
  cudaError_t err = launch_delta<T, D>(flash_bwd_streamk_delta_kernel<T, D>, o, os,
                                       dout, ds, glse, delta, s.B, s.H, s.Tq, stream);
  if (err != cudaSuccess) return err;
  const int pairs = s.live_pairs();
  if (pairs > 0 && s.B * s.H > 0) {
    if (pairs > 65535) return cudaErrorInvalidValue;
    CUtensorMap mq, mk, mv, mdo;
    err = encode_bthd_map(&mq, dtype, q, s.B, s.Tq, s.H, D, qs, L::PW, BQ);
    if (err == cudaSuccess) {
      err = encode_bthd_map(&mdo, dtype, dout, s.B, s.Tq, s.H, D, ds, L::PW, BQ);
    }
    if (err == cudaSuccess) {
      err = encode_bthd_map(&mk, dtype, k, s.B, s.Tk, s.H, D, ks, L::PW, BKT);
    }
    if (err == cudaSuccess) {
      err = encode_bthd_map(&mv, dtype, v, s.B, s.Tk, s.H, D, vs, L::PW, BKT);
    }
    if (err != cudaSuccess) return err;
    auto kern = flash_bwd_streamk_kernel<T, D>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::total);
    if (err != cudaSuccess) return err;
    kern<<<dim3(s.B * s.H, pairs), NTHREADS, L::total, stream>>>(mq, mk, mv, mdo, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  for (int mode = 0; mode < 2; ++mode) {
    const long long rows = (long long)s.B * s.H * (mode == 0 ? s.Tq : s.Tk);
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
cudaError_t dispatch_d(const StreamkArgs& s, int dtype, const void* q,
                       const void* k, const void* v, const void* o,
                       const void* dout, const long long* qs, const long long* ks,
                       const long long* vs, const long long* os,
                       const long long* ds, const float* glse, float* delta,
                       cudaStream_t stream) {
  switch (s.D) {
    case 16:
      return launch<T, 16>(s, dtype, q, k, v, o, dout, qs, ks, vs, os, ds, glse, delta, stream);
    case 32:
      return launch<T, 32>(s, dtype, q, k, v, o, dout, qs, ks, vs, os, ds, glse, delta, stream);
    case 64:
      return launch<T, 64>(s, dtype, q, k, v, o, dout, qs, ks, vs, os, ds, glse, delta, stream);
    case 128:
      return launch<T, 128>(s, dtype, q, k, v, o, dout, qs, ks, vs, os, ds, glse, delta, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (loaded with ctypes).  dtype: 0 = bf16, 1 = f16.
// *_strides: {batch, sequence, head} strides in elements of q/k/v/o/dO
// (multiples of 8; the last dim is contiguous, the bases 16-byte
// aligned).  lse, glse (or NULL) and the delta scratch are [B*H, Tq]
// f32; kv_mask is [B, Tk] bytes, 0 = masked, or NULL.  slot_w >= 1 keys
// per dQ partial; chunk_rows, a positive multiple of 64, query rows per
// block.  Workspace (see the header): dqp [B*H, ceil(Tk/slot_w),
// round_up(Tq, 64), D] f32 and dkp, dvp [B*H, ceil(Tq/chunk_rows), Tk,
// D] f32, none of which needs zeroing.  dq/dk/dv are contiguous
// [B, T, H, D] of the input type.  Encodes the TMA maps, launches the
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
  s.lse = lse;
  s.delta = delta;
  s.kv_mask = static_cast<const uint8_t*>(kv_mask);
  s.dqp = dqp;
  s.dkp = dkp;
  s.dvp = dvp;
  s.dq = dq;
  s.dk = dk;
  s.dv = dv;
  s.B = B;
  s.H = H;
  s.Tq = Tq;
  s.Tk = Tk;
  s.D = D;
  s.slot_w = slot_w;
  s.n_slots = (Tk + slot_w - 1) / slot_w;
  s.chunk_rows = chunk_rows;
  s.n_chunks = (Tq + chunk_rows - 1) / chunk_rows;
  s.Tq_pad = (Tq + BQ - 1) / BQ * BQ;
  s.scale = scale;
  s.causal = causal;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)dispatch_d<__nv_bfloat16>(s, dtype, q, k, v, o, dout, q_strides,
                                          k_strides, v_strides, o_strides,
                                          do_strides, glse, delta, st);
  }
  if (dtype == 1) {
    return (int)dispatch_d<__half>(s, dtype, q, k, v, o, dout, q_strides, k_strides,
                                   v_strides, o_strides, do_strides, glse, delta, st);
  }
  return (int)cudaErrorInvalidValue;
}
