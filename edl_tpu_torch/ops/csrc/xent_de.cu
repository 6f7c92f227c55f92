// Embedding gradient of the fused tied-vocab softmax cross entropy for
// Hopper (sm_90a): dE = dL^T Y in f32, with the [N, V] logits never
// reaching device memory.
//
// Replaces the TPU kernel edl_tpu/ops/fused_xent.py::_de_kernel
// (launched in _bwd).  Same function: logits = Y E^T per vocab tile,
// dL = ((exp(logit - lse) - onehot) * row_scale) cast to bf16 (the TPU
// kernel's dl.astype(bf16)), dE = dL^T Y accumulated in f32 and written
// for the first V rows.  Vocab entries at or past V are masked (dL 0),
// rows at or past N and rows with row_scale 0 give no gradient, and a
// label outside [0, V) has no one-hot.  Y [N, D] and E [V, D] are
// contiguous bf16.
//
// What bounds it on the H100.  At the training shape (N=16384, V=32000,
// D=768) the two products are 4*N*V*D = 1.61e12 FLOP, 1.63 ms at 989
// TFLOP/s dense bf16; Y and E are 74 MB, 0.02 ms at 3.35 TB/s.  So it
// is compute-bound, and the design is set by what a block can hold:
//
// - One block per 64 vocab rows (the wgmma M).  Its dE tile, 64 x 768
//   f32, is 192 KB: it lives in the registers of the block's two
//   warpgroups, 64 x 384 each (192 registers a thread).  128 vocab rows
//   would need 384 KB, more than an SM's 256 KB of registers.
// - The block's E tile (64 x 768 bf16, 96 KB) is loaded once by TMA and
//   stays in shared memory; Y streams through a 2-stage TMA ring of
//   32-row tiles (48 KB a stage): warp 0 refills a stage as soon as
//   both warpgroups have released it.  That is about 200 KB of the
//   227 KB.
// - Per Y tile, each consumer warpgroup computes the logits of 16 of
//   its 32 rows over the full D (S^T = E_tile Y_rows^T, wgmma m64n16,
//   both operands in shared memory, as interleaved partial sums, see
//   Precision below), so the logit product is split by rows.  dL^T is
//   formed on that fragment, which is exactly the register A fragment of one k16 step of the dE product; the two
//   warpgroups swap their fragments through 8 KB of shared memory and
//   one named barrier, then each accumulates dE[:, its 384 columns] +=
//   dL^T Y_tile[:, its columns] (wgmma m64n64 per 64-column panel, A
//   from registers, B = Y through the transpose bit), so the dE product
//   is split by columns.  The next tile's logit product is issued
//   before this tile's dE product has finished.  (Splitting the logit
//   product by depth instead, m64n32 over half of D per warpgroup and
//   one exchange of f32 partials, halves the E-tile operand reads but
//   needs 16 more registers a thread: at 255 ptxas spills or serializes
//   the wgmma pipeline, and on the H100 it ran at half this layout's
//   speed.)
// - Every block sweeps all of Y in the same order, so concurrent blocks
//   share each Y tile in L2: (V / 64) x N x D x 2 bytes = 500 x 25.2 MB
//   = 12.6 GB of L2 reads at N=16384 (half the 32-row first version's).
// - The sum over Y's rows runs in one fixed order inside one block, and
//   each dE element has one owner: no atomics, bit-identical run to run.
//
// Precision.  Where a row's label is also its argmax, p - 1 is tiny
// (~1e-5 with unit features at D = 1024, where logits spread by ~32)
// and is formed from a logit and an lse near 100, so an error of one
// f32 ulp in either is a large share of that dL entry.  Two choices
// keep the kernel's error there at the plain version's: the exponent is
// (s - lse) * log2(e), subtracted first (exact near p = 1), not
// s * log2(e) - lse * log2(e) with lse * log2(e) rounded on its own;
// and the logits are summed in 8 interleaved chains wherever the dE
// slice leaves the registers (2 at D = 768), since the tensor cores'
// f32 sums lose about an ulp of the partial sum per k16 step.
//
// Other widths (off the main path): D = 64 has one 64-column panel, so
// the second warpgroup computes logits but holds no dE columns.  At
// D = 1024 a 64 x 1024 f32 tile does not fit two warpgroups' registers:
// the dE columns are split across two blocks per vocab tile, each
// recomputing the logits, and the 128 KB E tile leaves room for one Y
// stage only (no load overlaps the products there).

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BV = 64;         // vocab rows per block (wgmma M)
constexpr int BN = 32;         // Y rows per streamed tile
constexpr int PW = 64;         // columns per panel (128-byte rows)
constexpr int ROW_BYTES = PW * 2;
constexpr int CONSUMERS = 2;
// two consumer warpgroups and nothing else: eight warps, two to each
// quarter of the SM's register file, so a thread may use up to 255
// registers, which the 192-register dE accumulator needs (a ninth,
// producer warp would put three warps on one quarter and cap every
// thread at 168).  Warp 0 starts the TMA loads itself.
constexpr int NTHREADS = 128 * CONSUMERS;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int NP = D / PW;                // panels of a row
  static constexpr int NCB = D > 768 ? 2 : 1;      // column blocks per vocab tile
  static constexpr int NPB = NP / NCB;             // dE panels per block
  static constexpr int PPW = (NPB + 1) / 2;        // dE panels of warpgroup 0
  static constexpr bool ODD = NPB % 2 != 0;        // warpgroup 1 has PPW - 1
  static constexpr int STAGES = D > 768 ? 1 : 2;
  // independent accumulation chains of the logit product: the tensor
  // cores' f32 sums lose about an ulp of the partial sum per k16 step,
  // so a chain's error grows with its length; 8 chains where the dE
  // slice leaves the registers (every D but 768), else 2
  static constexpr int CHAINS = PPW <= 4 ? (D / 16 < 8 ? D / 16 : 8) : 2;
  static constexpr size_t e_panel = size_t(BV) * ROW_BYTES;
  static constexpr size_t y_panel = size_t(BN) * ROW_BYTES;
  static constexpr size_t e_bytes = e_panel * NP;
  static constexpr size_t y_bytes = y_panel * NP;
  static constexpr size_t y_off = e_bytes;
  // two buffers x two warpgroups x 128 threads x one A fragment (16 B)
  static constexpr size_t x_off = y_off + STAGES * y_bytes;
  static constexpr size_t x_bytes = size_t(2) * CONSUMERS * 128 * 16;
  static constexpr size_t bar_off = x_off + x_bytes;
  // 1 + 2 * STAGES barriers, and slack to align the buffer to 1024 bytes
  static constexpr size_t total = bar_off + 64 + 1024;
  static_assert(total <= 232448, "shared memory of one block");
};

struct DeArgs {
  const int* labels;       // [N]
  const float* lse;        // [N]
  const float* row_scale;  // [N]
  float* de;               // [V, D]
  int N, V;
};

// lse, row_scale and label of one Y row (rows past N: no gradient)
struct RowStats {
  float lse, rs;
  int lab;
};

__device__ __forceinline__ RowStats row_stats(const DeArgs& a, int n) {
  RowStats r{0.f, 0.f, -1};
  if (n < a.N) {
    r.lse = a.lse[n];
    r.rs = a.row_scale[n];
    r.lab = a.labels[n];
  }
  return r;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
xent_de_kernel(const __grid_constant__ CUtensorMap tm_y,
               const __grid_constant__ CUtensorMap tm_e, const DeArgs a) {
  using L = Layout<D>;
  constexpr int NP = L::NP;
  constexpr int PPW = L::PPW;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* e_full = bars;
  uint64_t* y_full = bars + 1;            // [STAGES]
  uint64_t* y_empty = bars + 1 + STAGES;  // [STAGES]

  // warp-uniform to the compiler (a shuffle from lane 0), so branches on
  // it hold no wgmma in a divergent path
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  // warp 0 of warpgroup 0 refills the stages (lane 0 starts the loads)
  const bool load_warp = threadIdx.x < 32;
  const int v0 = (blockIdx.x / L::NCB) * BV;
  const int cb = blockIdx.x % L::NCB;
  const int n_tiles = (a.N + BN - 1) / BN;

  // Y tile `i` into its stage (one thread)
  auto load_y = [&](int i) {
    const int s = i % STAGES;
    unsigned char* sy = smem + L::y_off + s * L::y_bytes;
    mbar_arrive_expect_tx(&y_full[s], (uint32_t)L::y_bytes);
    for (int p = 0; p < NP; ++p) {
      tma_load_4d(sy + p * L::y_panel, &tm_y, &y_full[s], p * PW, 0, i * BN, 0);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(e_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&y_full[s], 1);
      mbar_init(&y_empty[s], NTHREADS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(e_full, (uint32_t)L::e_bytes);
    for (int p = 0; p < NP; ++p) {
      tma_load_4d(smem + p * L::e_panel, &tm_e, e_full, p * PW, 0, v0, 0);
    }
    for (int i = 0; i < STAGES && i < n_tiles; ++i) load_y(i);
  }
  __syncwarp();

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  // this thread's vocab rows: vrow + 8 i
  const int vrow = v0 + 16 * warp + g;
  // the first dE panel of this warpgroup (warpgroup 1 of an odd count
  // has PPW - 1: none at D = 64)
  const int pbase = cb * L::NPB + wg * PPW;
  const bool has_de = !L::ODD || wg == 0 || PPW > 1;
  const int np_mine = (L::ODD && wg == 1) ? PPW - 1 : PPW;
  uint4* xbuf = reinterpret_cast<uint4*>(smem + L::x_off);

  float acc[PPW][PW / 2];
#pragma unroll
  for (int p = 0; p < PPW; ++p)
#pragma unroll
    for (int i = 0; i < PW / 2; ++i) acc[p][i] = 0.f;

  // S^T = E_tile Y_rows^T over the full D for tile `it`: vocab rows x
  // this warpgroup's 16 Y rows (16 wg .. 16 wg + 15 of the tile), as
  // CHAINS partial sums over interleaved k16 steps, added pairwise once
  // they are done (chains of D / (16 CHAINS) small products: shorter
  // dependent chains, and less of the tensor cores' rounding)
  constexpr int CH = L::CHAINS;
  float sacc[CH][8];
  auto issue_logits = [&](int it) {
    const unsigned char* sy = smem + L::y_off + (it % STAGES) * L::y_bytes;
    mbar_wait(&y_full[it % STAGES], (it / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4;
      const int koff = (kk % 4) * 32;
      const uint64_t de = smem_desc(smem + p * L::e_panel + koff, ROW_BYTES);
      const uint64_t dy = smem_desc(sy + p * L::y_panel + 16 * wg * ROW_BYTES + koff, ROW_BYTES);
      wgmma_ss<bf16, 0, 0>(sacc[kk % CH], de, dy, kk >= CH);
    }
    wgmma_commit();
  };
  auto finish_logits = [&]() {
#pragma unroll
    for (int c = 0; c < CH; ++c) fence_operand(sacc[c]);
#pragma unroll
    for (int w = 1; w < CH; w *= 2)
#pragma unroll
      for (int c = 0; c + w < CH; c += 2 * w)
#pragma unroll
        for (int e = 0; e < 8; ++e) sacc[c][e] += sacc[c + w][e];
  };

  // this thread's Y rows of a tile: row0 + 8 nn + j
  const int row0 = 16 * wg + 2 * c;
  RowStats st[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) st[r] = row_stats(a, row0 + 8 * (r / 2) + r % 2);
  mbar_wait(e_full, 0);
  if (n_tiles > 0) {
    issue_logits(0);
    wgmma_wait<0>();
    finish_logits();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const unsigned char* sy = smem + L::y_off + s * L::y_bytes;

    // dL^T on the fragment: sacc[0][4 nn + 2 i + j] is vocab row vrow +
    // 8i, tile row row0 + 8 nn + j; as the A fragment of the k16 step of
    // this warpgroup's 16 rows: a[q] = (sacc[0][2q], sacc[0][2q + 1])
    float dl[8];
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const RowStats& r = st[2 * nn + j];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * nn + 2 * i + j;
          const int v = vrow + 8 * i;
          float x = 0.f;
          if (v < a.V && r.rs != 0.f) {
            // subtract first: near p = 1 the difference is exact, and
            // rounding lse * LOG2E on its own costs p - 1 its accuracy
            const float pr = exp2f((sacc[0][e] - r.lse) * LOG2E);
            x = (pr - (v == r.lab ? 1.f : 0.f)) * r.rs;
          }
          dl[e] = x;
        }
      }
    // the next tile's row statistics, in flight behind this tile's work
    if (it + 1 < n_tiles) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        st[r] = row_stats(a, (it + 1) * BN + row0 + 8 * (r / 2) + r % 2);
      }
    }
    uint32_t own[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) own[q] = pack2<bf16>(dl[2 * q], dl[2 * q + 1]);
    uint4* xb = xbuf + (it & 1) * CONSUMERS * 128;
    xb[wg * 128 + tid] = make_uint4(own[0], own[1], own[2], own[3]);
    named_barrier_sync(1, NTHREADS);
    const uint4 other = xb[(1 - wg) * 128 + tid];
    // k16 step 0 holds the tile's rows 0-15 (warpgroup 0's), step 1 rows
    // 16-31 (warpgroup 1's)
    uint32_t f0[4], f1[4];
    f0[0] = wg == 0 ? own[0] : other.x;
    f0[1] = wg == 0 ? own[1] : other.y;
    f0[2] = wg == 0 ? own[2] : other.z;
    f0[3] = wg == 0 ? own[3] : other.w;
    f1[0] = wg == 0 ? other.x : own[0];
    f1[1] = wg == 0 ? other.y : own[1];
    f1[2] = wg == 0 ? other.z : own[2];
    f1[3] = wg == 0 ? other.w : own[3];

    // dE[:, this warpgroup's columns] += dL^T Y_tile[:, its columns]
    if (has_de) {
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < PPW; ++p) {
        if (L::ODD && p >= np_mine) continue;
        const unsigned char* yp = sy + (pbase + p) * L::y_panel;
        wgmma_rs<bf16, 1>(acc[p], f0, smem_desc(yp, ROW_BYTES), 1);
        wgmma_rs<bf16, 1>(acc[p], f1, smem_desc(yp + 16 * ROW_BYTES, ROW_BYTES), 1);
      }
      wgmma_commit();
    }
    // The next tile's logits go in behind it (with one stage, only once
    // this tile's Y is released and reloaded); every product of this
    // iteration finishes in it.  Once both warpgroups have released a
    // stage, warp 0 refills it.
    const bool next = it + 1 < n_tiles;
    if (STAGES == 1) {
      wgmma_wait<0>();
      mbar_arrive(&y_empty[0]);
      if (load_warp && next) {
        mbar_wait(&y_empty[0], it & 1);
        if (lane == 0) load_y(it + 1);
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
      mbar_arrive(&y_empty[s]);
      if (load_warp && it + STAGES < n_tiles) {
        mbar_wait(&y_empty[s], (it / STAGES) & 1);
        if (lane == 0) load_y(it + STAGES);
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

  // acc[p][4n + 2i + j] is vocab row vrow + 8i, column
  // 64 (pbase + p) + 8n + 2c + j
  if (has_de) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = vrow + 8 * i;
      if (v >= a.V) continue;
      float* row = a.de + (long long)v * D + 2 * c;
#pragma unroll
      for (int p = 0; p < PPW; ++p) {
        if (L::ODD && p >= np_mine) continue;
#pragma unroll
        for (int n = 0; n < PW / 8; ++n) {
          *reinterpret_cast<float2*>(row + (pbase + p) * PW + 8 * n) =
              make_float2(acc[p][4 * n + 2 * i], acc[p][4 * n + 2 * i + 1]);
        }
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* y, const void* e, const DeArgs& a, cudaStream_t stream) {
  using L = Layout<D>;
  const int blocks = (a.V + BV - 1) / BV * L::NCB;
  if (blocks == 0) return cudaSuccess;
  if (a.N == 0) {
    return cudaMemsetAsync(a.de, 0, (size_t)a.V * D * sizeof(float), stream);
  }
  // Y and E as [1, rows, 1, D] (hopper.cuh's 4-D maps), contiguous
  CUtensorMap my, me;
  const long long ys[3] = {(long long)a.N * D, D, D};
  const long long es[3] = {(long long)a.V * D, D, D};
  cudaError_t err = encode_bthd_map(&my, 0, y, 1, a.N, 1, D, ys, PW, BN);
  if (err == cudaSuccess) err = encode_bthd_map(&me, 0, e, 1, a.V, 1, D, es, PW, BV);
  if (err != cudaSuccess) return err;
  auto kern = xent_de_kernel<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::total);
  if (err != cudaSuccess) return err;
  kern<<<blocks, NTHREADS, L::total, stream>>>(my, me, a);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes).  y: [N, D] bf16, e: [V, D] bf16,
// labels: [N] int32, all contiguous with 16-byte aligned bases; lse and
// row_scale: [N] f32; D in {64, 128, 256, 512, 768, 1024}.  Writes dE
// [V, D] f32.  Encodes the TMA maps, launches one kernel on `stream` and
// returns its cudaError_t.
extern "C" int edl_xent_de(const void* y, const void* e, const int* labels,
                           const float* lse, const float* row_scale, int N,
                           int V, int D, float* de, void* stream) {
  DeArgs a;
  a.labels = labels;
  a.lse = lse;
  a.row_scale = row_scale;
  a.de = de;
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
