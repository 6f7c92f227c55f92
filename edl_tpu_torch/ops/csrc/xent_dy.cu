// Features' gradient of the fused tied-vocab softmax cross entropy for
// Hopper (sm_90a): dY = dL E, with the [N, V] logits and dL never
// reaching device memory.
//
// Replaces the TPU kernel edl_tpu/ops/fused_xent.py::_dy_kernel
// (launched in _bwd).  Same function: logits = Y E^T per vocab tile,
// dL = ((exp(logit - lse) - onehot) * row_scale) cast to bf16 (the TPU
// kernel's dl.astype(bf16)), dY = dL E accumulated in f32 and written
// as bf16.  Vocab entries at or past V are masked (dL 0), rows with
// row_scale 0 get a zero gradient, and a label outside [0, V) has no
// one-hot.  Y [N, D] and E [V, D] are contiguous bf16.
//
// What bounds it on the H100.  At the training shape (N=16384, V=32000,
// D=768) the two products are 4*N*V*D = 1.61e12 FLOP, 1.63 ms at 989
// TFLOP/s dense bf16; Y, E and dY are 99 MB, 0.03 ms at 3.35 TB/s.  So
// it is compute-bound.  The layout is xent_de.cu's (B6) with the roles
// of Y and E swapped:
//
// - One block per 64 Y rows (the wgmma M).  Its dY tile, 64 x 768 f32,
//   is 192 KB: it lives in the registers of the block's two consumer
//   warpgroups, 64 x 384 each (192 registers a thread), so the block
//   is those 256 threads and no producer warp (a ninth warp would cap
//   every thread at 168 registers); warp 0 refills the ring itself.
// - The block's Y tile (64 x 768 bf16, 96 KB) is loaded once by TMA and
//   stays in shared memory; E streams through a 2-stage TMA ring of
//   32-row vocab tiles (48 KB a stage), refilled as soon as both
//   warpgroups have released a stage.  About 200 KB of the 227 KB.
// - The row statistics (lse, row_scale, label) of a thread's two Y
//   rows stay in registers for the whole sweep.
// - Per E tile, each warpgroup computes the logits of 16 of its 32
//   vocab rows over the full D (S = Y_tile E_rows^T, wgmma m64n16, both
//   operands in shared memory, as interleaved partial sums), and forms
//   dL on that fragment in base 2.  The packed bf16 fragment is exactly
//   the register A operand of one k16 step of the dY product, so the
//   two warpgroups swap their fragments through 8 KB of shared memory
//   and one named barrier; then each accumulates dY[:, its 384 columns]
//   += dL E_tile[:, its columns] (wgmma m64n64 per 64-column panel, A
//   from registers, B = E through the transpose bit).  The next tile's
//   logit product is issued before this tile's dY product has finished.
// - Every block sweeps all of E in the same order, so concurrent blocks
//   share each E tile in L2: (N / 64) x V x D x 2 bytes = 256 x 49 MB =
//   12.6 GB of L2 reads at N=16384 (half the 32-row first version's).
// - The sum over the vocab runs in one fixed order inside one block,
//   and each dY element has one owner: no atomics, bit-identical run to
//   run.
//
// Precision.  Where a row's label is also its argmax, p - 1 is tiny
// (~1e-5 with unit features) and formed from a logit and an lse near
// 100, and that one entry decides the row's dY (dY = rs (sum_v p_v E_v
// - E_label)): an error of an ulp or two in the label's logit is a
// large share of the row.  The tensor cores' f32 sums lose about an ulp
// of the partial sum per k16 step, and at D = 768 the dY slice leaves
// registers for only 2 accumulation chains of 24 steps (8 chains
// elsewhere).  So each thread takes its rows' label logits from a
// float64 dot product on the CUDA cores (D FMAs a row, a few
// microseconds in all), exact to f32, and uses them for the label's
// entry only; and, as xent_de.cu, the exponent is (s - lse) * log2(e),
// subtracted first (exact near p = 1).
//
// Other widths (off the main path): D = 64 has one 64-column panel, so
// the second warpgroup computes logits but holds no dY columns.  At
// D = 1024 a 64 x 1024 f32 tile does not fit two warpgroups' registers:
// the dY columns are split across two blocks per Y tile, each
// recomputing the logits, and the 128 KB Y tile leaves room for one E
// stage only (no load overlaps the products there).

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;         // Y rows per block (wgmma M)
constexpr int BV = 32;         // vocab rows per streamed E tile
constexpr int PW = 64;         // columns per panel (128-byte rows)
constexpr int ROW_BYTES = PW * 2;
constexpr int CONSUMERS = 2;
constexpr int NTHREADS = 128 * CONSUMERS;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int NP = D / PW;                // panels of a row
  static constexpr int NCB = D > 768 ? 2 : 1;      // column blocks per Y tile
  static constexpr int NPB = NP / NCB;             // dY panels per block
  static constexpr int PPW = (NPB + 1) / 2;        // dY panels of warpgroup 0
  static constexpr bool ODD = NPB % 2 != 0;        // warpgroup 1 has PPW - 1
  static constexpr int STAGES = D > 768 ? 1 : 2;
  // interleaved accumulation chains of the logit product (Precision)
  static constexpr int CHAINS = PPW <= 4 ? (D / 16 < 8 ? D / 16 : 8) : 2;
  static constexpr size_t y_panel = size_t(BM) * ROW_BYTES;
  static constexpr size_t e_panel = size_t(BV) * ROW_BYTES;
  static constexpr size_t y_bytes = y_panel * NP;
  static constexpr size_t e_bytes = e_panel * NP;
  static constexpr size_t e_off = y_bytes;
  // two buffers x two warpgroups x 128 threads x one A fragment (16 B)
  static constexpr size_t x_off = e_off + STAGES * e_bytes;
  static constexpr size_t x_bytes = size_t(2) * CONSUMERS * 128 * 16;
  static constexpr size_t bar_off = x_off + x_bytes;
  // 1 + 2 * STAGES barriers, and slack to align the buffer to 1024 bytes
  static constexpr size_t total = bar_off + 64 + 1024;
  static_assert(total <= 232448, "shared memory of one block");
};

struct DyArgs {
  const bf16* y;           // [N, D]
  const bf16* e;           // [V, D]
  const int* labels;       // [N]
  const float* lse;        // [N]
  const float* row_scale;  // [N]
  bf16* dy;                // [N, D]
  int N, V;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
xent_dy_kernel(const __grid_constant__ CUtensorMap tm_y,
               const __grid_constant__ CUtensorMap tm_e, const DyArgs a) {
  using L = Layout<D>;
  constexpr int NP = L::NP;
  constexpr int PPW = L::PPW;
  constexpr int STAGES = L::STAGES;
  constexpr int CH = L::CHAINS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* y_full = bars;
  uint64_t* e_full = bars + 1;            // [STAGES]
  uint64_t* e_empty = bars + 1 + STAGES;  // [STAGES]

  // warp-uniform to the compiler (a shuffle from lane 0), so branches on
  // it hold no wgmma in a divergent path
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  // warp 0 of warpgroup 0 refills the stages (lane 0 starts the loads)
  const bool load_warp = threadIdx.x < 32;
  const int m0 = (blockIdx.x / L::NCB) * BM;
  const int cb = blockIdx.x % L::NCB;
  const int n_tiles = (a.V + BV - 1) / BV;

  // E tile `i` into its stage (one thread)
  auto load_e = [&](int i) {
    const int s = i % STAGES;
    unsigned char* se = smem + L::e_off + s * L::e_bytes;
    mbar_arrive_expect_tx(&e_full[s], (uint32_t)L::e_bytes);
    for (int p = 0; p < NP; ++p) {
      tma_load_4d(se + p * L::e_panel, &tm_e, &e_full[s], p * PW, 0, i * BV, 0);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(y_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&e_full[s], 1);
      mbar_init(&e_empty[s], NTHREADS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(y_full, (uint32_t)L::y_bytes);
    for (int p = 0; p < NP; ++p) {
      tma_load_4d(smem + p * L::y_panel, &tm_y, y_full, p * PW, 0, m0, 0);
    }
    for (int i = 0; i < STAGES && i < n_tiles; ++i) load_e(i);
  }
  __syncwarp();

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  // this thread's Y rows: yrow + 8 i, with their statistics (rows past
  // N: scale 0, no gradient)
  const int yrow = m0 + 16 * warp + g;
  float lse[2], rs[2];
  int lab[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = yrow + 8 * i;
    const bool in = n < a.N;
    lse[i] = in ? a.lse[n] : 0.f;
    rs[i] = in ? a.row_scale[n] : 0.f;
    lab[i] = in ? a.labels[n] : -1;
  }
  // the label's logit of each row, exact to f32: a float64 dot product
  // over the row's 4 threads (8 columns of each 32), summed in a fixed
  // order (the same in all 4)
  float slab[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    double dot = 0.0;
    if (lab[i] >= 0 && lab[i] < a.V) {
      const bf16* yr = a.y + (long long)(yrow + 8 * i) * D;
      const bf16* er = a.e + (long long)lab[i] * D;
      for (int k = 8 * c; k < D; k += 32) {
        const uint4 yv = __ldg(reinterpret_cast<const uint4*>(yr + k));
        const uint4 ev = __ldg(reinterpret_cast<const uint4*>(er + k));
        const bf16* yb = reinterpret_cast<const bf16*>(&yv);
        const bf16* eb = reinterpret_cast<const bf16*>(&ev);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          dot = fma((double)__bfloat162float(yb[t]), (double)__bfloat162float(eb[t]), dot);
        }
      }
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    slab[i] = (float)dot;
  }
  // the first dY panel of this warpgroup (warpgroup 1 of an odd count
  // has PPW - 1: none at D = 64)
  const int pbase = cb * L::NPB + wg * PPW;
  const bool has_dy = !L::ODD || wg == 0 || PPW > 1;
  const int np_mine = (L::ODD && wg == 1) ? PPW - 1 : PPW;
  uint4* xbuf = reinterpret_cast<uint4*>(smem + L::x_off);

  float acc[PPW][PW / 2];
#pragma unroll
  for (int p = 0; p < PPW; ++p)
#pragma unroll
    for (int i = 0; i < PW / 2; ++i) acc[p][i] = 0.f;

  // S = Y_tile E_rows^T over the full D for tile `it`: the block's Y rows
  // x this warpgroup's 16 vocab rows (16 wg .. 16 wg + 15 of the tile),
  // as CH partial sums over interleaved k16 steps, added pairwise once
  // they are done
  float sacc[CH][8];
  auto issue_logits = [&](int it) {
    const unsigned char* se = smem + L::e_off + (it % STAGES) * L::e_bytes;
    mbar_wait(&e_full[it % STAGES], (it / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4;
      const int koff = (kk % 4) * 32;
      const uint64_t dy = smem_desc(smem + p * L::y_panel + koff, ROW_BYTES);
      const uint64_t de = smem_desc(se + p * L::e_panel + 16 * wg * ROW_BYTES + koff, ROW_BYTES);
      wgmma_ss<bf16, 0, 0>(sacc[kk % CH], dy, de, kk >= CH);
    }
    wgmma_commit();
  };
  auto finish_logits = [&]() {
#pragma unroll
    for (int k = 0; k < CH; ++k) fence_operand(sacc[k]);
#pragma unroll
    for (int w = 1; w < CH; w *= 2)
#pragma unroll
      for (int k = 0; k + w < CH; k += 2 * w)
#pragma unroll
        for (int e = 0; e < 8; ++e) sacc[k][e] += sacc[k + w][e];
  };

  mbar_wait(y_full, 0);
  if (n_tiles > 0) {
    issue_logits(0);
    wgmma_wait<0>();
    finish_logits();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const unsigned char* se = smem + L::e_off + s * L::e_bytes;

    // dL on the fragment: sacc[0][4 n + 2 i + j] is Y row yrow + 8 i,
    // vocab entry vcol + 8 n + j; as the A fragment of this warpgroup's
    // k16 step: a[q] = (sacc[0][2q], sacc[0][2q + 1])
    const int vcol = it * BV + 16 * wg + 2 * c;
    float dl[8];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 4 * n + 2 * i + j;
          const int v = vcol + 8 * n + j;
          float x = 0.f;
          if (v < a.V && rs[i] != 0.f) {
            const bool hot = v == lab[i];
            const float pr = exp2f(((hot ? slab[i] : sacc[0][e]) - lse[i]) * LOG2E);
            x = (pr - (hot ? 1.f : 0.f)) * rs[i];
          }
          dl[e] = x;
        }
    uint32_t own[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) own[q] = pack2<bf16>(dl[2 * q], dl[2 * q + 1]);
    uint4* xb = xbuf + (it & 1) * CONSUMERS * 128;
    xb[wg * 128 + tid] = make_uint4(own[0], own[1], own[2], own[3]);
    named_barrier_sync(1, NTHREADS);
    const uint4 other = xb[(1 - wg) * 128 + tid];
    // k16 step 0 holds the tile's vocab rows 0-15 (warpgroup 0's), step
    // 1 rows 16-31 (warpgroup 1's)
    uint32_t f0[4], f1[4];
    f0[0] = wg == 0 ? own[0] : other.x;
    f0[1] = wg == 0 ? own[1] : other.y;
    f0[2] = wg == 0 ? own[2] : other.z;
    f0[3] = wg == 0 ? own[3] : other.w;
    f1[0] = wg == 0 ? other.x : own[0];
    f1[1] = wg == 0 ? other.y : own[1];
    f1[2] = wg == 0 ? other.z : own[2];
    f1[3] = wg == 0 ? other.w : own[3];

    // dY[:, this warpgroup's columns] += dL E_tile[:, its columns]
    if (has_dy) {
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < PPW; ++p) {
        if (L::ODD && p >= np_mine) continue;
        const unsigned char* ep = se + (pbase + p) * L::e_panel;
        wgmma_rs<bf16, 1>(acc[p], f0, smem_desc(ep, ROW_BYTES), 1);
        wgmma_rs<bf16, 1>(acc[p], f1, smem_desc(ep + 16 * ROW_BYTES, ROW_BYTES), 1);
      }
      wgmma_commit();
    }
    // The next tile's logits go in behind it (with one stage, only once
    // this tile's E is released and reloaded); every product of this
    // iteration finishes in it.  Once both warpgroups have released a
    // stage, warp 0 refills it.
    const bool next = it + 1 < n_tiles;
    if (STAGES == 1) {
      wgmma_wait<0>();
      mbar_arrive(&e_empty[0]);
      if (load_warp && next) {
        mbar_wait(&e_empty[0], it & 1);
        if (lane == 0) load_e(it + 1);
        __syncwarp();
      }
      if (next) issue_logits(it + 1);
    } else {
      if (next) {
        issue_logits(it + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      mbar_arrive(&e_empty[s]);
      if (load_warp && it + STAGES < n_tiles) {
        mbar_wait(&e_empty[s], (it / STAGES) & 1);
        if (lane == 0) load_e(it + STAGES);
        __syncwarp();
      }
    }
    wgmma_wait<0>();
    if (next) finish_logits();
    fence_operand(f0);
    fence_operand(f1);
  }
#pragma unroll
  for (int p = 0; p < PPW; ++p) fence_operand(acc[p]);

  // acc[p][4n + 2i + j] is Y row yrow + 8i, column
  // 64 (pbase + p) + 8n + 2c + j
  if (has_dy) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = yrow + 8 * i;
      if (n >= a.N) continue;
      bf16* row = a.dy + (long long)n * D + 2 * c;
#pragma unroll
      for (int p = 0; p < PPW; ++p) {
        if (L::ODD && p >= np_mine) continue;
#pragma unroll
        for (int k = 0; k < PW / 8; ++k) {
          *reinterpret_cast<uint32_t*>(row + (pbase + p) * PW + 8 * k) =
              pack2<bf16>(acc[p][4 * k + 2 * i], acc[p][4 * k + 2 * i + 1]);
        }
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* y, const void* e, const DyArgs& a, cudaStream_t stream) {
  using L = Layout<D>;
  const int blocks = (a.N + BM - 1) / BM * L::NCB;
  if (blocks == 0) return cudaSuccess;
  if (a.V == 0) {
    return cudaMemsetAsync(a.dy, 0, (size_t)a.N * D * sizeof(bf16), stream);
  }
  // Y and E as [1, rows, 1, D] (hopper.cuh's 4-D maps), contiguous
  CUtensorMap my, me;
  const long long ys[3] = {(long long)a.N * D, D, D};
  const long long es[3] = {(long long)a.V * D, D, D};
  cudaError_t err = encode_bthd_map(&my, 0, y, 1, a.N, 1, D, ys, PW, BM);
  if (err == cudaSuccess) err = encode_bthd_map(&me, 0, e, 1, a.V, 1, D, es, PW, BV);
  if (err != cudaSuccess) return err;
  auto kern = xent_dy_kernel<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::total);
  if (err != cudaSuccess) return err;
  kern<<<blocks, NTHREADS, L::total, stream>>>(my, me, a);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes).  y: [N, D] bf16, e: [V, D] bf16,
// labels: [N] int32, all contiguous with 16-byte aligned bases; lse and
// row_scale: [N] f32; D in {64, 128, 256, 512, 768, 1024}.  Writes dY
// [N, D] bf16.  Encodes the TMA maps, launches one kernel on `stream`
// and returns its cudaError_t.
extern "C" int edl_xent_dy(const void* y, const void* e, const int* labels,
                           const float* lse, const float* row_scale, int N,
                           int V, int D, void* dy, void* stream) {
  DyArgs a;
  a.y = static_cast<const bf16*>(y);
  a.e = static_cast<const bf16*>(e);
  a.labels = labels;
  a.lse = lse;
  a.row_scale = row_scale;
  a.dy = static_cast<bf16*>(dy);
  a.N = N;
  a.V = V;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64>(y, e, a, st);
    case 128:
      return (int)launch<128>(y, e, a, st);
    case 256:
      return (int)launch<256>(y, e, a, st);
    case 512:
      return (int)launch<512>(y, e, a, st);
    case 768:
      return (int)launch<768>(y, e, a, st);
    case 1024:
      return (int)launch<1024>(y, e, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
