// Loss statistics of the fused tied-vocab softmax cross entropy for
// Hopper (sm_90a): per row of Y, the logsumexp, the label's logit and the
// row max of the logits Y E^T, with the [N, V] logits never reaching
// device memory.
//
// Replaces the TPU kernel edl_tpu/ops/fused_xent.py::_fwd_kernel
// (launched by _fwd): an online max / sum-exp over vocab tiles.  Vocab
// entries at or past V are masked; a label outside [0, V) has label
// logit 0.  Y [N, D] and E [V, D] are contiguous bf16; the logits are
// f32 sums of their products.
//
// What bounds it on the H100.  At the training shape (N=16384, V=32000,
// D=768) the product is 2*N*V*D = 8.05e11 FLOP, 0.81 ms at 989 TFLOP/s
// dense bf16; Y and E are 74 MB (0.02 ms at 3.35 TB/s); the epilogue's
// 5.2e8 exponentials take ~0.14 ms of the SMs' SFU time.  So it is one
// matrix product with a row-reduction epilogue and no output wider than
// three floats a row, and the design is a Hopper GEMM mainloop:
//
// - One block per 128 Y rows: two warpgroups of 64 rows (the wgmma M).
//   The block sweeps the vocab in 256-row tiles; per tile each
//   warpgroup accumulates its 64 x 256 logits S in registers (two
//   m64n128 f32 accumulators, 128 registers a thread).  The block is
//   those 8 warps and no producer warp: a ninth warp caps every thread
//   at 168 registers, and there ptxas spilled the epilogue (~400 bytes
//   a thread).  Warp 0 refills the ring itself.
// - Both operands stream in 64-column D panels (the block's 128 Y rows,
//   16 KB, and the tile's 256 E rows, 32 KB) through a 4-stage TMA ring
//   (192 KB): a stage is refilled as soon as both warpgroups have
//   released it, so while the block runs one tile's epilogue the next
//   tile's first panels are already loading.  A resident 128-row Y tile
//   (192 KB at D=768) would leave no room for the ring.
// - The mainloop keeps one panel's products in flight (wgmma wait depth
//   1) and releases each stage as soon as its products are done.
// - The epilogue folds S into each row's running max and sum-exp on the
//   fragment (B1's softmax on the fragment, csrc/flash_fwd.cu: a thread
//   holds 2 rows x 64 columns of a tile, a row's 4 threads combine their
//   maxima by shuffles) and picks the label's logit out of the same
//   registers, so row_max and label_logit are the same f32 values and a
//   label that is its row's argmax satisfies label_logit >= row_max.
// - L2 reads: (N / 128) x (V / 256) x (128 + 256) x D x 2 bytes = 9.4 GB
//   at N=16384.  All blocks sweep the vocab in the same order, so each E
//   panel comes from device memory once and from L2 for the other
//   blocks.
// - Every statistic has one owner and a fixed order of summation: no
//   atomics, bit-identical run to run.

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;        // Y rows per block (two warpgroups of 64)
constexpr int BN = 256;        // vocab rows per tile
constexpr int HALF = 128;      // vocab rows of one m64n128 accumulator
constexpr int PW = 64;         // columns per panel (128-byte rows)
constexpr int ROW_BYTES = PW * 2;
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;
constexpr int NTHREADS = 128 * CONSUMERS;
constexpr size_t Y_PANEL = size_t(BM) * ROW_BYTES;
constexpr size_t E_PANEL = size_t(BN) * ROW_BYTES;
constexpr size_t STAGE_BYTES = Y_PANEL + E_PANEL;
constexpr size_t BAR_OFF = STAGES * STAGE_BYTES;
// 2 * STAGES barriers, and slack to align the buffer to 1024 bytes
constexpr size_t SMEM_BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
constexpr float LOG2E = 1.4426950408889634f;

struct FwdArgs {
  const int* labels;  // [N]
  float* lse;         // [N]
  float* label_logit; // [N]
  float* row_max;     // [N]
  int N, V;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
xent_fwd_kernel(const __grid_constant__ CUtensorMap tm_y,
                const __grid_constant__ CUtensorMap tm_e, const FwdArgs a) {
  constexpr int NP = D / PW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);  // [STAGES]
  uint64_t* empty = full + STAGES;                                // [STAGES]

  // warp-uniform to the compiler (a shuffle from lane 0), so branches on
  // it hold no wgmma in a divergent path
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  // warp 0 of warpgroup 0 refills the stages (lane 0 alone waits for a
  // stage and starts its loads); warp-uniform to the compiler, as wg is
  const bool load_warp = wg == 0 && warp == 0;
  const int m0 = blockIdx.x * BM;
  const int n_tiles = (a.V + BN - 1) / BN;
  const int n_panels = n_tiles * NP;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NTHREADS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // panel q of the sweep is D panel q % NP of vocab tile q / NP, in
  // stage q % STAGES (one thread)
  auto load = [&](int q) {
    const int s = q % STAGES;
    unsigned char* st = smem + s * STAGE_BYTES;
    const int col = (q % NP) * PW;
    mbar_arrive_expect_tx(&full[s], (uint32_t)STAGE_BYTES);
    tma_load_4d(st, &tm_y, &full[s], col, 0, m0, 0);
    tma_load_4d(st + Y_PANEL, &tm_e, &full[s], col, 0, (q / NP) * BN, 0);
  };
  // this thread is done with panel q's stage; once both warpgroups are,
  // warp 0 loads panel q + STAGES into it
  auto release = [&](int q) {
    mbar_arrive(&empty[q % STAGES]);
    if (load_warp && q + STAGES < n_panels) {
      if (lane == 0) {
        mbar_wait(&empty[q % STAGES], (q / STAGES) & 1);
        load(q + STAGES);
      }
      __syncwarp();
    }
  };
  if (threadIdx.x == 0) {
    for (int q = 0; q < STAGES && q < n_panels; ++q) load(q);
  }
  __syncwarp();

  const int g = lane / 4;
  const int c = lane % 4;
  // this thread's rows: row + 8 i
  const int row = m0 + 64 * wg + 16 * warp + g;
  int lab[2];
  float m[2], l[2], lv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = row + 8 * i;
    const int x = n < a.N ? a.labels[n] : -1;
    lab[i] = x < a.V ? x : -1;  // a label past V has no logit
    m[i] = -INFINITY;
    l[i] = 0.f;
    lv[i] = 0.f;
  }

  // S[h][4n + 2i + j] is row `row + 8 i`, vocab entry
  // tile * BN + HALF h + 8 n + 2 c + j
  float S[2][64];
  int q = 0;
  for (int t = 0; t < n_tiles; ++t) {
    fence_operand(S[0]);
    fence_operand(S[1]);
    for (int kp = 0; kp < NP; ++kp, ++q) {
      const int s = q % STAGES;
      const unsigned char* sy = smem + s * STAGE_BYTES + 64 * wg * ROW_BYTES;
      const unsigned char* se = smem + s * STAGE_BYTES + Y_PANEL;
      mbar_wait(&full[s], (q / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = smem_desc(sy + kk * 32, ROW_BYTES);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          wgmma_ss<bf16, 0, 0>(S[h], da, smem_desc(se + HALF * h * ROW_BYTES + kk * 32, ROW_BYTES),
                               kp > 0 || kk > 0);
        }
      }
      wgmma_commit();
      // the previous panel's products are done: release its stage
      if (kp > 0) {
        wgmma_wait<1>();
        release(q - 1);
      }
    }
    wgmma_wait<0>();
    release(q - 1);
    fence_operand(S[0]);
    fence_operand(S[1]);

    // fold the tile into each row's running max and sum-exp
    const int v0 = t * BN + 2 * c;
    const bool ragged = (t + 1) * BN > a.V;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = S[h][4 * n + 2 * i + j];
            if (ragged && v0 + HALF * h + 8 * n + j >= a.V) x = -INFINITY;
            tmax = fmaxf(tmax, x);
          }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      // the label's logit, from the same registers as the max
      if (lab[i] >= t * BN && lab[i] < (t + 1) * BN) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int n = 0; n < 16; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (v0 + HALF * h + 8 * n + j == lab[i]) lv[i] = S[h][4 * n + 2 * i + j];
            }
      }
      const float m_new = fmaxf(m[i], tmax);
      const float mb = m_new * LOG2E;
      float sum = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) sum += exp2f(fmaf(S[h][4 * n + 2 * i + j], LOG2E, -mb));
      l[i] = l[i] * exp2f((m[i] - m_new) * LOG2E) + sum;
      m[i] = m_new;
    }
  }

  // a row's four threads: add their partial sums and label logits (one
  // thread holds the label's, the others 0)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lv[i] += __shfl_xor_sync(0xffffffffu, lv[i], 1);
    lv[i] += __shfl_xor_sync(0xffffffffu, lv[i], 2);
    const int n = row + 8 * i;
    if (c == 0 && n < a.N) {
      a.lse[n] = m[i] + logf(l[i]);
      a.label_logit[n] = lv[i];
      a.row_max[n] = m[i];
    }
  }
}

template <int D>
cudaError_t launch(const void* y, const void* e, const FwdArgs& a, cudaStream_t stream) {
  const int blocks = (a.N + BM - 1) / BM;
  if (blocks == 0) return cudaSuccess;
  if (a.V == 0) return cudaErrorInvalidValue;
  // Y and E as [1, rows, 1, D] (hopper.cuh's 4-D maps), contiguous
  CUtensorMap my, me;
  const long long ys[3] = {(long long)a.N * D, D, D};
  const long long es[3] = {(long long)a.V * D, D, D};
  cudaError_t err = encode_bthd_map(&my, 0, y, 1, a.N, 1, D, ys, PW, BM);
  if (err == cudaSuccess) err = encode_bthd_map(&me, 0, e, 1, a.V, 1, D, es, PW, BN);
  if (err != cudaSuccess) return err;
  auto kern = xent_fwd_kernel<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kern<<<blocks, NTHREADS, SMEM_BYTES, stream>>>(my, me, a);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes).  y: [N, D] bf16, e: [V, D] bf16,
// labels: [N] int32, all contiguous with 16-byte aligned bases; V >= 1;
// D in {64, 128, 256, 512, 768, 1024}.  Writes the lse, label logit and
// row max, each [N] f32.  Encodes the TMA maps, launches one kernel on
// `stream` and returns its cudaError_t.
extern "C" int edl_xent_fwd(const void* y, const void* e, const int* labels,
                            int N, int V, int D, float* out_lse,
                            float* out_label, float* out_max, void* stream) {
  FwdArgs a;
  a.labels = labels;
  a.lse = out_lse;
  a.label_logit = out_label;
  a.row_max = out_max;
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
