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
// What bounds it on the H100.  At the training shape [8, 2048, 12, 64]
// causal the function is its five products, 10*B*H*D*T*(T+1)/2 =
// 1.29e11 FLOP, 0.13 ms at 989 TFLOP/s dense bf16, against about 0.2 GB
// of Q/K/V/O/dO/dQ/dK/dV/lse, 0.06 ms at 3.35 TB/s: compute-bound.  So
// the design keeps the tensor cores fed (wgmma with f32 accumulators in
// registers, TMA loads in flight behind a producer warp) and nothing of
// the [T, T] matrices in memory.
//
// The TPU kernel keeps a full-T f32 dK/dV scratch resident per
// (batch*head) while Q tiles stream through a sequential grid; Hopper
// blocks run in parallel with nothing carried between them.  A merged
// kernel here would have to write dQ as per-key-tile partials: at the
// training shape 96 x 272 = 26,112 live (128-key tile, 64-row Q tile)
// pairs x 16 KB = 428 MB written and as much read back by a reduce,
// 0.26 ms at 3.35 TB/s (twice the kernel's bound) in an 805 MB
// workspace that grows as T^2.  Recomputing S and dP in a separate dQ
// kernel instead costs two extra products, 2*2*B*H*D*T*(T+1)/2 =
// 5.2e10 FLOP, 0.05 ms at the bf16 peak, and no workspace.  So the work
// is three launches, none with atomics (bit-identical run to run):
//
// 1. delta (flash_bwd_delta.cuh): one pass over O and dO, f32.
// 2. dK/dV: one block per (batch*head, 128-key tile), the lowest key
//    tiles (the longest causal sweeps) first.  Two consumer warpgroups
//    hold 64 keys each, with their f32 dK and dV in registers for the
//    whole sweep; a producer warp loads K and V once (TMA) and streams
//    Q, dO (TMA) and lse, delta of 64-row Q tiles from the causal
//    diagonal on through a 2-stage mbarrier ring.  Per (key tile, Q
//    tile) pair, four wgmma products:
//      S^T = K Q^T, dP^T = V dO^T  (A = K, V; B = Q, dO: shared, K-major;
//                                   P^T is computed on S^T's fragment
//                                   while dP^T is still in flight)
//      dV += P^T dO, dK += dS^T Q  (A = P^T, dS^T from registers; B = dO,
//                                   Q through the transpose bit)
//    dK is scaled and both are written once.
// 3. dQ: one block per (batch*head, 128-row Q tile), the highest Q tiles
//    first.  Two consumer warpgroups of 64 rows; Q and dO are loaded
//    once (TMA), K and V of 128-key tiles go through a 2-stage ring (K
//    and V with barriers of their own) up to the diagonal.  Per half
//    tile of 64 keys, three products:
//      S = Q K^T, dP = dO V^T      (into registers; P on S's fragment
//                                   while dP is in flight)
//      dQ += dS K                  (A = dS from registers, B = K through
//                                   the transpose bit; in flight while
//                                   the next half's S and dP start)
//    dQ stays in registers, is scaled and written once.
//
// Registers: a block of two consumer warpgroups and a producer warp is
// nine warps, three of which share one quarter of the SM's register
// file, so ptxas gives a thread at most 168.  The S, dP and dS of 128
// keys next to dQ would spill and serialize the wgmma pipeline; 64 keys
// at a time fit.  (Eight-warp blocks, with warp 0 starting the loads,
// allow 255 registers, 128-row Q tiles in the dK/dV kernel and whole
// 128-key products in the dQ kernel; on the H100 the dK/dV kernel
// gained 3% and the dQ kernel lost more, its halves' overlap gone.)
//
// Masking: causal tiles wholly above the diagonal are never loaded; only
// tiles that cross it, a ragged end or a key mask pay the per-element
// mask; masked pairs give P = 0 and dS = 0, so a fully masked row gets
// zero gradients.  Ragged T: TMA reads zeros past the sequence's end;
// those keys are masked and those rows never written.  Q, K, V, O and
// dO are read in place from [B, T, H, D] with arbitrary batch/sequence/
// head strides (the slices of a fused QKV projection need no copy); dQ,
// dK, dV are written contiguous [B, T, H, D]; lse, g_lse and delta are
// [B*H, Tq] f32.
//
// Shared memory at D = 64: dK/dV 32 KB of K and V + 2 x 17 KB stages;
// dQ 32 KB of Q and dO + 2 x 32 KB of K and V.

#include "flash_bwd_delta.cuh"
#include "hopper.cuh"

namespace {

constexpr int BKT = 128;  // keys per key tile
constexpr int BKH = 64;   // keys per half tile of the dQ kernel's products
constexpr int BQ = 64;    // query rows per Q tile of the dK/dV kernel
constexpr int BM = 128;   // query rows per block of the dQ kernel
constexpr int CONSUMERS = 2;
// two consumer warpgroups and one producer warp
constexpr int NTHREADS = 128 * CONSUMERS + 32;
constexpr float LOG2E = 1.4426950408889634f;

// Tiles are D / PW panels of [rows, PW] (hopper.cuh); every region is
// 1024-byte aligned.
template <int D>
struct Panels {
  static constexpr int PW = D < 64 ? D : 64;
  static constexpr int NP = D / PW;
  static constexpr int ROW_BYTES = PW * 2;
  static constexpr int KPP = PW / 16;  // k16 steps per panel
  static constexpr size_t key_panel = size_t(BKT) * ROW_BYTES;
  static constexpr size_t key_bytes = key_panel * NP;  // one K or V tile
};

// dK/dV kernel: K and V of the key tile, two Q stages (Q, dO, lse *
// log2(e), delta of 64 rows), the barriers.
template <int D>
struct KvLayout : Panels<D> {
  using P = Panels<D>;
  static constexpr size_t q_panel = size_t(BQ) * P::ROW_BYTES;
  static constexpr size_t q_bytes = q_panel * P::NP;  // one Q or dO tile
  static constexpr size_t v_off = P::key_bytes;
  static constexpr size_t stage_off = 2 * P::key_bytes;
  static constexpr size_t stats_off = 2 * q_bytes;  // within a stage
  static constexpr size_t stage_bytes = (2 * q_bytes + 2 * BQ * 4 + 1023) / 1024 * 1024;
  static constexpr size_t bar_off = stage_off + 2 * stage_bytes;
  // 5 barriers, and slack to align the dynamic buffer to 1024 bytes
  static constexpr size_t total = bar_off + 64 + 1024;
};

// dQ kernel: Q and dO of the block's 128 rows, two K/V stages.
template <int D>
struct QLayout : Panels<D> {
  using P = Panels<D>;
  static constexpr size_t q_panel = size_t(BM) * P::ROW_BYTES;
  static constexpr size_t q_bytes = q_panel * P::NP;
  static constexpr size_t do_off = q_bytes;
  static constexpr size_t k_off = 2 * q_bytes;
  static constexpr size_t v_off = k_off + 2 * P::key_bytes;
  static constexpr size_t bar_off = v_off + 2 * P::key_bytes;
  // 7 barriers, and slack to align the dynamic buffer to 1024 bytes
  static constexpr size_t total = bar_off + 64 + 1024;
};

struct BwdArgs {
  const float* lse;        // [B*H, Tq]
  const float* delta;      // [B*H, Tq]
  const uint8_t* kv_mask;  // [B, Tk] or null
  void* dq;                // [B, Tq, H, D]
  void* dk;                // [B, Tk, H, D]
  void* dv;                // [B, Tk, H, D]
  int H, Tq, Tk;
  float scale;
  int causal;
};

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

// Write this thread's two rows (row0, row0 + 8) of a [rows, D] f32
// accumulator fragment, times `mul`, to row `row0 + 8 i` of a contiguous
// [B, n_rows, H, D] output; rows at or past n_rows are not written.
template <typename T, int D>
__device__ __forceinline__ void write_rows(
    const float (&acc)[Panels<D>::NP][Panels<D>::PW / 2], float mul, void* out,
    int b, int h, int H, int n_rows, int row0, int cc) {
  constexpr int PW = Panels<D>::PW;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= n_rows) continue;
    T* orow = static_cast<T*>(out) + ((long long)(b * n_rows + r) * H + h) * D + 2 * cc;
#pragma unroll
    for (int p = 0; p < Panels<D>::NP; ++p)
#pragma unroll
      for (int n = 0; n < PW / 8; ++n) {
        *reinterpret_cast<uint32_t*>(orow + p * PW + 8 * n) =
            pack2<T>(acc[p][4 * n + 2 * i] * mul, acc[p][4 * n + 2 * i + 1] * mul);
      }
  }
}

// dK and dV of one (batch*head, 128-key tile).
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do, const BwdArgs a) {
  using L = KvLayout<D>;
  constexpr int PW = L::PW;
  constexpr int NP = L::NP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* kv_full = bars;
  uint64_t* q_full = bars + 1;   // [2]
  uint64_t* q_empty = bars + 3;  // [2]

  // warp-uniform to the compiler (a shuffle from lane 0), so branches on
  // it hold no wgmma in a divergent path
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  // the lowest key tiles first: under a causal mask they sweep the most
  // Q tiles, so the long blocks start early and the short ones fill in
  const int k0 = blockIdx.y * BKT;
  const int n_qt = (a.Tq + BQ - 1) / BQ;
  const int qt0 = a.causal ? k0 / BQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 32);  // the producer warp's lanes
      mbar_init(&q_empty[i], CONSUMERS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: the last warp ----
    {
      const int lane = tid;
      const float* lse_bh = a.lse + (long long)bh * a.Tq;
      const float* delta_bh = a.delta + (long long)bh * a.Tq;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, (uint32_t)(2 * L::key_bytes));
        for (int p = 0; p < NP; ++p) {
          tma_load_4d(smem + p * L::key_panel, &tm_k, kv_full, p * PW, h, k0, b);
          tma_load_4d(smem + L::v_off + p * L::key_panel, &tm_v, kv_full, p * PW, h, k0, b);
        }
      }
      int it = 0;
      for (int qt = qt0; qt < n_qt; ++qt, ++it) {
        const int st = it & 1;
        const int r = it >> 1;
        if (r > 0) mbar_wait(&q_empty[st], (r - 1) & 1);
        unsigned char* stage = smem + L::stage_off + st * L::stage_bytes;
        float* stats = reinterpret_cast<float*>(stage + L::stats_off);
        const int q0 = qt * BQ;
#pragma unroll
        for (int rr = lane; rr < BQ; rr += 32) {
          const int q = q0 + rr;
          stats[rr] = q < a.Tq ? lse_bh[q] * LOG2E : 0.f;
          stats[BQ + rr] = q < a.Tq ? delta_bh[q] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&q_full[st], (uint32_t)(2 * L::q_bytes));
          for (int p = 0; p < NP; ++p) {
            tma_load_4d(stage + p * L::q_panel, &tm_q, &q_full[st], p * PW, h, q0, b);
            tma_load_4d(stage + L::q_bytes + p * L::q_panel, &tm_do, &q_full[st], p * PW,
                        h, q0, b);
          }
        } else {
          mbar_arrive(&q_full[st]);
        }
      }
    }
  } else {
    // ---- consumers: 64 keys per warpgroup ----
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int cc = lane % 4;
    const uint8_t* mrow = a.kv_mask ? a.kv_mask + (long long)b * a.Tk : nullptr;
    const float scale_log2 = a.scale * LOG2E;
    const int kw0 = k0 + 64 * wg;           // this warpgroup's first key
    const int key0 = kw0 + 16 * warp + g;   // this thread's keys: key0, key0 + 8
    const unsigned char* skw = smem + 64 * wg * L::ROW_BYTES;
    const unsigned char* svw = smem + L::v_off + 64 * wg * L::ROW_BYTES;

    float dk[NP][PW / 2], dv[NP][PW / 2];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < PW / 2; ++i) dk[p][i] = dv[p][i] = 0.f;
    mbar_wait(kv_full, 0);

    int it = 0;
    for (int qt = qt0; qt < n_qt; ++qt, ++it) {
      const int st = it & 1;
      const int q0 = qt * BQ;
      const unsigned char* sq = smem + L::stage_off + st * L::stage_bytes;
      const unsigned char* sdo = sq + L::q_bytes;
      const float* stats = reinterpret_cast<const float*>(sq + L::stats_off);

      // S^T = K Q^T and dP^T = V dO^T, two commit groups: rows = this
      // warpgroup's keys, columns = the tile's 64 query rows
      float sacc[BQ / 2], dpacc[BQ / 2];
      mbar_wait(&q_full[st], (it >> 1) & 1);
      fence_operand(sacc);
      fence_operand(dpacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk / L::KPP;
        const int koff = (kk % L::KPP) * 32;
        wgmma_ss<T, 0, 0>(sacc, smem_desc(skw + p * L::key_panel + koff, L::ROW_BYTES),
                          smem_desc(sq + p * L::q_panel + koff, L::ROW_BYTES), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk / L::KPP;
        const int koff = (kk % L::KPP) * 32;
        wgmma_ss<T, 0, 0>(dpacc, smem_desc(svw + p * L::key_panel + koff, L::ROW_BYTES),
                          smem_desc(sdo + p * L::q_panel + koff, L::ROW_BYTES), kk > 0);
      }
      wgmma_commit();

      // P^T on S^T's fragment while dP^T is in flight: element
      // [4n + 2i + jj] is key key0 + 8i, query row q0 + 8n + 2cc + jj.
      // Masked pairs and rows past Tq give P = 0 (so dS = 0).
      wgmma_wait<1>();
      fence_operand(sacc);
      const bool need_mask = (a.causal && kw0 + 63 > q0) || (kw0 + 64 > a.Tk) ||
                             (q0 + BQ > a.Tq) || (mrow != nullptr);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = 8 * n + 2 * cc + jj;
          const float lse2 = stats[col];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * n + 2 * i + jj;
            bool keep = true;
            if (need_mask) {
              const int kp = key0 + 8 * i;
              const int qp = q0 + col;
              keep = qp < a.Tq && kp < a.Tk && (!a.causal || kp <= qp) &&
                     (mrow == nullptr || mrow[kp] != 0);
            }
            sacc[e] = keep ? exp2f(sacc[e] * scale_log2 - lse2) : 0.f;
          }
        }
      }
      wgmma_wait<0>();
      fence_operand(dpacc);
      // dS^T = P^T (dP^T - delta), and both as register A fragments (k16
      // steps over the 64 query rows)
      uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int qd = 0; qd < 4; ++qd) {
          const int e = 8 * kk + 2 * qd;  // query rows 16kk + 8(qd/2) + 2cc + {0, 1}
          const float d0 = stats[BQ + 16 * kk + 8 * (qd / 2) + 2 * cc];
          const float d1 = stats[BQ + 16 * kk + 8 * (qd / 2) + 2 * cc + 1];
          pf[kk][qd] = pack2<T>(sacc[e], sacc[e + 1]);
          dsf[kk][qd] = pack2<T>(sacc[e] * (dpacc[e] - d0), sacc[e + 1] * (dpacc[e + 1] - d1));
        }

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
    }

    write_rows<T, D>(dk, a.scale, a.dk, b, h, a.H, a.Tk, key0, cc);
    write_rows<T, D>(dv, 1.f, a.dv, b, h, a.H, a.Tk, key0, cc);
  }
}

// dQ of one (batch*head, 128-row Q tile).
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const BwdArgs a) {
  using L = QLayout<D>;
  constexpr int PW = L::PW;
  constexpr int NP = L::NP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;    // [2]
  uint64_t* v_full = bars + 3;    // [2]
  uint64_t* kv_empty = bars + 5;  // [2]

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  // the highest Q tiles first: under a causal mask they sweep the most
  // key tiles
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  int n_kt = (a.Tk + BKT - 1) / BKT;
  if (a.causal) n_kt = min(n_kt, (q0 + BM - 1) / BKT + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], CONSUMERS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread of the last warp starts every TMA load ----
    if (tid == 0) {
      // Q and dO of the block's rows, as two 64-row boxes per panel
      mbar_arrive_expect_tx(q_full, (uint32_t)(2 * L::q_bytes));
      for (int p = 0; p < NP; ++p)
        for (int half = 0; half < 2; ++half) {
          const int off = p * L::q_panel + half * 64 * L::ROW_BYTES;
          tma_load_4d(smem + off, &tm_q, q_full, p * PW, h, q0 + 64 * half, b);
          tma_load_4d(smem + L::do_off + off, &tm_do, q_full, p * PW, h, q0 + 64 * half, b);
        }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt & 1;
        const int r = kt >> 1;
        if (r > 0) mbar_wait(&kv_empty[s], (r - 1) & 1);
        unsigned char* sk = smem + L::k_off + s * L::key_bytes;
        unsigned char* sv = smem + L::v_off + s * L::key_bytes;
        mbar_arrive_expect_tx(&k_full[s], (uint32_t)L::key_bytes);
        for (int p = 0; p < NP; ++p) {
          tma_load_4d(sk + p * L::key_panel, &tm_k, &k_full[s], p * PW, h, kt * BKT, b);
        }
        mbar_arrive_expect_tx(&v_full[s], (uint32_t)L::key_bytes);
        for (int p = 0; p < NP; ++p) {
          tma_load_4d(sv + p * L::key_panel, &tm_v, &v_full[s], p * PW, h, kt * BKT, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int cc = lane % 4;
    const uint8_t* mrow = a.kv_mask ? a.kv_mask + (long long)b * a.Tk : nullptr;
    const float scale_log2 = a.scale * LOG2E;
    const int qw0 = q0 + 64 * wg;          // this warpgroup's first row
    const int row0 = qw0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    float lse2[2], dlt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      const bool in = r < a.Tq;
      lse2[i] = in ? a.lse[(long long)bh * a.Tq + r] * LOG2E : 0.f;
      dlt[i] = in ? a.delta[(long long)bh * a.Tq + r] : 0.f;
    }
    const unsigned char* sq = smem + 64 * wg * L::ROW_BYTES;
    const unsigned char* sdo = smem + L::do_off + 64 * wg * L::ROW_BYTES;

    float dq[NP][PW / 2];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < PW / 2; ++i) dq[p][i] = 0.f;

    mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt & 1;
      const uint32_t parity = (kt >> 1) & 1;
      const unsigned char* sk = smem + L::k_off + s * L::key_bytes;
      const unsigned char* sv = smem + L::v_off + s * L::key_bytes;
      mbar_wait(&k_full[s], parity);
      mbar_wait(&v_full[s], parity);

      // The tile's two halves of 64 keys in turn (S, dP and dS of 128
      // keys at once would not fit the 168 registers of a thread); the
      // second half's S and dP go in while the first half's dQ product
      // is still in flight.
      uint32_t dsf[2][BKH / 16][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int k0 = kt * BKT + hh * BKH;
        const unsigned char* skh = sk + hh * BKH * L::ROW_BYTES;
        const unsigned char* svh = sv + hh * BKH * L::ROW_BYTES;

        // S = Q K^T, then dP = dO V^T in a second commit group
        float sacc[BKH / 2], dpacc[BKH / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int p = kk / L::KPP;
          const int koff = (kk % L::KPP) * 32;
          wgmma_ss<T, 0, 0>(sacc, smem_desc(sq + p * L::q_panel + koff, L::ROW_BYTES),
                            smem_desc(skh + p * L::key_panel + koff, L::ROW_BYTES), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int p = kk / L::KPP;
          const int koff = (kk % L::KPP) * 32;
          wgmma_ss<T, 0, 0>(dpacc, smem_desc(sdo + p * L::q_panel + koff, L::ROW_BYTES),
                            smem_desc(svh + p * L::key_panel + koff, L::ROW_BYTES), kk > 0);
        }
        wgmma_commit();

        // P on S's fragment while dP is in flight (and the first half's
        // dQ product is done): sacc[4n + 2i + j] is row row0 + 8i, key
        // k0 + 8n + 2cc + j
        wgmma_wait<1>();
        fence_operand(sacc);
        if (hh == 1) {
#pragma unroll
          for (int kk = 0; kk < BKH / 16; ++kk) fence_operand(dsf[0][kk]);
        }
        const bool need_mask =
            (a.causal && k0 + BKH - 1 > qw0) || (k0 + BKH > a.Tk) || (mrow != nullptr);
#pragma unroll
        for (int n = 0; n < BKH / 8; ++n) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            bool kept[2] = {true, true};
            if (need_mask) {
              const int kp = k0 + 8 * n + 2 * cc + j;
              const bool key_ok = kp < a.Tk && (mrow == nullptr || mrow[kp] != 0);
#pragma unroll
              for (int i = 0; i < 2; ++i) kept[i] = key_ok && (!a.causal || kp <= row0 + 8 * i);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int e = 4 * n + 2 * i + j;
              sacc[e] = kept[i] ? exp2f(sacc[e] * scale_log2 - lse2[i]) : 0.f;
            }
          }
        }
        wgmma_wait<0>();
        fence_operand(dpacc);
        // dS = P (dP - delta) as the register A fragment (k16 steps over
        // the half's 64 keys)
#pragma unroll
        for (int kk = 0; kk < BKH / 16; ++kk)
#pragma unroll
          for (int qd = 0; qd < 4; ++qd) {
            const int e = 8 * kk + 2 * qd;  // row row0 + 8 (qd % 2)
            const float d = dlt[qd % 2];
            dsf[hh][kk][qd] =
                pack2<T>(sacc[e] * (dpacc[e] - d), sacc[e + 1] * (dpacc[e + 1] - d));
          }

        // dQ += dS K_half (B = the half's keys through the transpose bit)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKH / 16; ++kk)
#pragma unroll
          for (int p = 0; p < NP; ++p)
            wgmma_rs<T, 1>(dq[p], dsf[hh][kk],
                           smem_desc(skh + p * L::key_panel + kk * 16 * L::ROW_BYTES,
                                     L::ROW_BYTES),
                           1);
        wgmma_commit();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < BKH / 16; ++kk) fence_operand(dsf[1][kk]);
      mbar_arrive(&kv_empty[s]);
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_operand(dq[p]);

    write_rows<T, D>(dq, a.scale, a.dq, b, h, a.H, a.Tq, row0, cc);
  }
}

template <typename T, int D>
cudaError_t launch(const BwdArgs& a, int dtype, int B, const void* q, const void* k,
                   const void* v, const void* o, const void* dout, const long long* qs,
                   const long long* ks, const long long* vs, const long long* os,
                   const long long* ds, const float* glse, float* delta,
                   cudaStream_t stream) {
  using P = Panels<D>;
  cudaError_t err = launch_delta<T, D>(flash_bwd_delta_kernel<T, D>, o, os, dout, ds,
                                       glse, delta, B, a.H, a.Tq, stream);
  if (err != cudaSuccess) return err;
  const int bh = B * a.H;
  const int n_kt = (a.Tk + BKT - 1) / BKT;
  const int n_qt = (a.Tq + BM - 1) / BM;
  // (an empty dimension fails the encoding: TMA maps need every extent >= 1)
  CUtensorMap mq, mk, mv, mdo;
  err = encode_bthd_map(&mq, dtype, q, B, a.Tq, a.H, D, qs, P::PW, BQ);
  if (err == cudaSuccess) err = encode_bthd_map(&mdo, dtype, dout, B, a.Tq, a.H, D, ds, P::PW, BQ);
  if (err == cudaSuccess) err = encode_bthd_map(&mk, dtype, k, B, a.Tk, a.H, D, ks, P::PW, BKT);
  if (err == cudaSuccess) err = encode_bthd_map(&mv, dtype, v, B, a.Tk, a.H, D, vs, P::PW, BKT);
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)KvLayout<D>::total);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(bh, n_kt), NTHREADS, KvLayout<D>::total, stream>>>(mq, mk, mv, mdo, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dq = flash_bwd_dq_kernel<T, D>;
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)QLayout<D>::total);
  if (err != cudaSuccess) return err;
  dq<<<dim3(bh, n_qt), NTHREADS, QLayout<D>::total, stream>>>(mq, mk, mv, mdo, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const BwdArgs& a, int dtype, int B, const void* q,
                       const void* k, const void* v, const void* o, const void* dout,
                       const long long* qs, const long long* ks, const long long* vs,
                       const long long* os, const long long* ds, const float* glse,
                       float* delta, cudaStream_t stream) {
#define EDL_BWD_CASE(DD)                                                                \
  case DD:                                                                             \
    return launch<T, DD>(a, dtype, B, q, k, v, o, dout, qs, ks, vs, os, ds, glse, delta, \
                         stream);
  switch (D) {
    EDL_BWD_CASE(16)
    EDL_BWD_CASE(32)
    EDL_BWD_CASE(64)
    EDL_BWD_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef EDL_BWD_CASE
}

}  // namespace

// C interface (loaded with ctypes).  dtype: 0 = bf16, 1 = f16.
// *_strides: {batch, sequence, head} strides in elements of q/k/v/o/dO
// (multiples of 8; the last dim is contiguous, the bases 16-byte
// aligned).  lse, glse (or NULL) and the delta scratch are [B*H, Tq]
// f32; kv_mask is [B, Tk] bytes, 0 = masked, or NULL.  dq/dk/dv are
// contiguous [B, T, H, D] of the input type.  Encodes the TMA maps,
// launches the delta, dK/dV and dQ kernels on `stream`, in that order,
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
  BwdArgs a;
  a.lse = lse;
  a.delta = delta;
  a.kv_mask = static_cast<const uint8_t*>(kv_mask);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.scale = scale;
  a.causal = causal;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)dispatch_d<__nv_bfloat16>(D, a, dtype, B, q, k, v, o, dout, q_strides,
                                          k_strides, v_strides, o_strides, do_strides,
                                          glse, delta, st);
  }
  if (dtype == 1) {
    return (int)dispatch_d<__half>(D, a, dtype, B, q, k, v, o, dout, q_strides,
                                   k_strides, v_strides, o_strides, do_strides, glse,
                                   delta, st);
  }
  return (int)cudaErrorInvalidValue;
}
