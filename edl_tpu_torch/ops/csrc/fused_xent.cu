// Fused tied-vocab softmax cross entropy for Hopper (sm_90a): the loss
// statistics and the features' gradient of softmax(Y E^T) without the
// [N, V] logits ever reaching device memory.  (The embedding's gradient,
// the TPU kernel _de_kernel, is xent_de.cu.)
//
// Replaces the TPU kernels of edl_tpu/ops/fused_xent.py:
//
// - mode 0, _fwd_kernel (launched by _fwd): per row, the logsumexp,
//   the label's logit and the row max, by an online max / sum-exp over
//   vocab tiles;
// - mode 1, _dy_kernel (in _bwd): dY = dL E with the logits recomputed
//   per vocab tile;
//
// where dL = ((softmax - onehot) * row_scale) cast to bf16, as the TPU
// kernels' `dl.astype(bf16)`.  Y [N, D] and E [V, D] are bf16, the
// products accumulate in f32, and vocab entries at or past V are masked
// (NEG_INF logits, dL 0), as the TPU kernels mask their padded vocab.
//
// The TPU tiles (up to 1024 x 1024, each with a [rows, D] f32
// accumulator in VMEM) do not fit a Hopper block: at D=768 a 64-row f32
// accumulator alone is 192 KB.  So one kernel template serves both
// modes with a 32-row "outer" tile of Y, resident in shared memory for
// the whole block (8 warps), and a 64-row "inner" tile of E streamed
// through it, sweeping the vocab.
//
// Each step computes the [32, 64] logit tile with WMMA 16x16x16 (bf16
// in, f32 out) into shared memory; mode 0 folds it into each row's
// running max and sum (8 lanes per row, in registers); mode 1 writes dL
// for the tile as bf16 and adds dL [32, 64] x inner [64, D] to the
// block's [32, D] f32 result, held as WMMA accumulators in registers
// (D/64 fragments per warp) and written once at the end.
// Every output element has one owner and a fixed order of summation:
// no atomics, and the result is bit-identical run to run.
//
// Bound on the H100 at the training shape (N=16384, V=32000, D=768):
// the logits are 2*N*V*D = 8.05e11 FLOP (0.81 ms at 989 TFLOP/s dense
// bf16) for mode 0 and twice that, with the recomputed logits, for
// mode 1 (1.63 ms); the bytes (Y and E, 74 MB) take 0.02 ms —
// compute-bound.  This first version streams the inner tile with
// synchronous loads (no TMA, no double buffering), so each block reads
// all of E once from L2 (about 25 GB in all per mode) and runs well
// above its bound; its measured time is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BO = 32;  // outer rows per block
constexpr int BI = 64;  // inner rows per streamed tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LANES_PER_ROW = NTHREADS / BO;  // 8 lanes own one outer row
constexpr int COLS_PER_LANE = BI / LANES_PER_ROW;
constexpr float NEG_INF = -1e30f;

enum Mode { FWD = 0, DY = 1 };

__device__ __forceinline__ float safe_max(float m) {
  return m <= NEG_INF * 0.5f ? 0.f : m;
}

// Shared-memory layout.  Rows are padded (8 bf16 or 4 f32 values) so
// the WMMA tiles of consecutive rows fall in different banks; regions
// and 16-row tile offsets stay 32-byte aligned.  The f32 staging of the
// result reuses the inner tile.
template <int D>
struct Smem {
  static constexpr int LDT = D + 8;   // outer / inner rows (bf16)
  static constexpr int LDS = BI + 4;  // logit tile rows (f32)
  static constexpr int LDL = BI + 8;  // dL tile rows (bf16)
  static constexpr int LDA = D + 4;   // result staging rows (f32)
  static constexpr size_t outer_off = 0;
  static constexpr size_t inner_off = outer_off + size_t(BO) * LDT * 2;
  static constexpr size_t s_off = inner_off + size_t(BI) * LDT * 2;
  static constexpr size_t dl_off = s_off + size_t(BO) * LDS * 4;
  static constexpr size_t stat_off = dl_off + size_t(BO) * LDL * 2;
  // per-row lse, row_scale and label of the outer (32) rows
  static constexpr size_t total = stat_off + size_t(3) * BO * 4;
  static_assert(size_t(BO) * LDA * 4 <= size_t(BI) * LDT * 2,
                "result staging must fit in the inner tile");
};

// Stage `count` rows from row0 of a contiguous [n_rows, D] bf16 matrix;
// rows at or past n_rows are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0,
                                          int n_rows, int count, int tid) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  constexpr int LD = Smem<D>::LDT;
  for (int i = tid; i < count * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// Per-row lse, row scale and label of `count` rows of Y from row0;
// rows at or past N get label -1 and scale 0 (no gradient).
__device__ __forceinline__ void load_stats(float* s_lse, float* s_scale,
                                           int* s_lab, const float* lse,
                                           const float* row_scale,
                                           const int* labels, int row0, int N,
                                           int count, int tid) {
  for (int i = tid; i < count; i += NTHREADS) {
    const int n = row0 + i;
    const bool in = n < N;
    s_lse[i] = in ? lse[n] : 0.f;
    s_scale[i] = in ? row_scale[n] : 0.f;
    s_lab[i] = in ? labels[n] : -1;
  }
}

template <int MODE, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
xent_kernel(const bf16* __restrict__ y, const bf16* __restrict__ e,
            const int* __restrict__ labels, const float* __restrict__ lse,
            const float* __restrict__ row_scale, int N, int V,
            float* __restrict__ out_lse, float* __restrict__ out_label,
            float* __restrict__ out_max, bf16* __restrict__ dy) {
  using S = Smem<D>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  // result fragments per warp: [BO, D] in 16x16 fragments over 8 warps
  constexpr int FPW = (BO / 16) * (D / 16) / NWARPS;
  constexpr int DF = D / 16;
  static_assert((BO / 16) * (D / 16) % NWARPS == 0, "D must be a multiple of 64");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sOut = reinterpret_cast<bf16*>(smem + S::outer_off);
  bf16* sIn = reinterpret_cast<bf16*>(smem + S::inner_off);
  float* sS = reinterpret_cast<float*>(smem + S::s_off);
  bf16* sDL = reinterpret_cast<bf16*>(smem + S::dl_off);
  float* sOutLse = reinterpret_cast<float*>(smem + S::stat_off);
  float* sOutScale = sOutLse + BO;
  int* sOutLab = reinterpret_cast<int*>(sOutScale + BO);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  // rows of Y are outer, rows of E inner
  const int o0 = blockIdx.x * BO;

  load_rows<D>(sOut, y, o0, N, BO, tid);
  if (MODE == DY) {
    load_stats(sOutLse, sOutScale, sOutLab, lse, row_scale, labels, o0, N, BO,
               tid);
  }

  // The lanes of a group of 8 own one outer row and 8 columns each of
  // every logit tile.
  const int o = tid / LANES_PER_ROW;
  const int c0 = (tid % LANES_PER_ROW) * COLS_PER_LANE;
  float m = NEG_INF, l = 0.f, lab_logit = 0.f;
  int lab = -1;
  if (MODE == FWD && o0 + o < N) lab = labels[o0 + o];

  Acc acc[FPW];
  if (MODE != FWD) {
#pragma unroll
    for (int f = 0; f < FPW; ++f) wmma::fill_fragment(acc[f], 0.f);
  }

  const int n_tiles = (V + BI - 1) / BI;
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * BI;
    __syncthreads();  // every warp is done with the previous inner tile
    load_rows<D>(sIn, e, i0, V, BI, tid);
    __syncthreads();

    // logits [BO, BI] = outer x inner^T: one 16x16 fragment per warp
    {
      const int fr = warp / (BI / 16);
      const int fc = warp % (BI / 16);
      Acc sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll 8
      for (int kk = 0; kk < DF; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(af, sOut + fr * 16 * S::LDT + kk * 16, S::LDT);
        wmma::load_matrix_sync(bfr, sIn + fc * 16 * S::LDT + kk * 16, S::LDT);
        wmma::mma_sync(sf, af, bfr, sf);
      }
      wmma::store_matrix_sync(sS + fr * 16 * S::LDS + fc * 16, sf, S::LDS,
                              wmma::mem_row_major);
    }
    __syncthreads();

    const float* srow = sS + o * S::LDS + c0;
    if (MODE == FWD) {
      float x[COLS_PER_LANE];
      float tmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < COLS_PER_LANE; ++j) {
        const int v = i0 + c0 + j;
        float logit = srow[j];
        if (v >= V) {
          logit = NEG_INF;
        } else if (v == lab) {
          lab_logit += logit;
        }
        x[j] = logit;
        tmax = fmaxf(tmax, logit);
      }
#pragma unroll
      for (int off = LANES_PER_ROW / 2; off > 0; off >>= 1) {
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      }
      const float m_new = fmaxf(m, tmax);
      const float m_use = safe_max(m_new);
      const float alpha = expf(safe_max(m) - m_use);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < COLS_PER_LANE; ++j) psum += expf(x[j] - m_use);
#pragma unroll
      for (int off = LANES_PER_ROW / 2; off > 0; off >>= 1) {
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      }
      l = l * alpha + psum;
      m = m_new;
    } else {
      bf16* dlrow = sDL + o * S::LDL + c0;
#pragma unroll
      for (int j = 0; j < COLS_PER_LANE; ++j) {
        const int i = c0 + j;
        // (row of Y, vocab entry) of this logit
        const int n = o0 + o;
        const int v = i0 + i;
        const float lse_n = sOutLse[o];
        const float scale_n = sOutScale[o];
        const int lab_n = sOutLab[o];
        float dl = 0.f;
        if (n < N && v < V) {
          const float p = expf(srow[j] - lse_n);
          dl = (p - (v == lab_n ? 1.f : 0.f)) * scale_n;
        }
        dlrow[j] = __float2bfloat16(dl);
      }
      __syncthreads();
      // result [BO, D] += dL [BO, BI] x inner [BI, D]
#pragma unroll
      for (int f = 0; f < FPW; ++f) {
        const int fi = warp * FPW + f;
        const int fr = fi / DF;
        const int fc = fi % DF;
#pragma unroll
        for (int kk = 0; kk < BI / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(af, sDL + fr * 16 * S::LDL + kk * 16, S::LDL);
          wmma::load_matrix_sync(bfr, sIn + kk * 16 * S::LDT + fc * 16, S::LDT);
          wmma::mma_sync(acc[f], af, bfr, acc[f]);
        }
      }
    }
  }

  if (MODE == FWD) {
#pragma unroll
    for (int off = LANES_PER_ROW / 2; off > 0; off >>= 1) {
      lab_logit += __shfl_xor_sync(0xffffffffu, lab_logit, off);
    }
    const int n = o0 + o;
    if (tid % LANES_PER_ROW == 0 && n < N) {
      const float ms = safe_max(m);
      out_lse[n] = ms + logf(fmaxf(l, 1e-30f));
      out_label[n] = lab_logit;
      out_max[n] = ms;
    }
    return;
  }

  __syncthreads();  // the inner tile becomes the result staging area
  float* staging = reinterpret_cast<float*>(sIn);
#pragma unroll
  for (int f = 0; f < FPW; ++f) {
    const int fi = warp * FPW + f;
    wmma::store_matrix_sync(staging + (fi / DF) * 16 * S::LDA + (fi % DF) * 16,
                            acc[f], S::LDA, wmma::mem_row_major);
  }
  __syncthreads();
  constexpr int CHUNKS = D / 8;
  for (int i = tid; i < BO * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const int row = o0 + r;
    if (row >= N) continue;
    const float* src = staging + r * S::LDA + c;
    alignas(16) bf16 pack[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) pack[j] = __float2bfloat16(src[j]);
    *reinterpret_cast<uint4*>(dy + (long long)row * D + c) =
        *reinterpret_cast<const uint4*>(pack);
  }
}

template <int MODE, int D>
cudaError_t launch(const void* y, const void* e, const int* labels,
                   const float* lse, const float* row_scale, int N, int V,
                   float* out_lse, float* out_label, float* out_max, void* dy,
                   cudaStream_t stream) {
  using S = Smem<D>;
  auto kern = xent_kernel<MODE, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::total);
  if (err != cudaSuccess) return err;
  const int blocks = (N + BO - 1) / BO;
  if (blocks == 0) return cudaSuccess;
  kern<<<blocks, NTHREADS, S::total, stream>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(e), labels, lse,
      row_scale, N, V, out_lse, out_label, out_max, static_cast<bf16*>(dy));
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch_d(int D, const void* y, const void* e, const int* labels,
                       const float* lse, const float* row_scale, int N, int V,
                       float* out_lse, float* out_label, float* out_max,
                       void* dy, cudaStream_t stream) {
#define EDL_XENT_CASE(DD)                                                     \
  case DD:                                                                    \
    return launch<MODE, DD>(y, e, labels, lse, row_scale, N, V, out_lse,      \
                            out_label, out_max, dy, stream);
  switch (D) {
    EDL_XENT_CASE(64)
    EDL_XENT_CASE(128)
    EDL_XENT_CASE(256)
    EDL_XENT_CASE(512)
    EDL_XENT_CASE(768)
    EDL_XENT_CASE(1024)
    default:
      return cudaErrorInvalidValue;
  }
#undef EDL_XENT_CASE
}

}  // namespace

// C interface (loaded with ctypes).  y: [N, D] bf16, e: [V, D] bf16,
// labels: [N] int32, all contiguous; lse and row_scale: [N] f32.  Each
// launches one kernel on `stream` and returns its cudaError_t.

// -> lse, label logit and row max, each [N] f32
extern "C" int edl_xent_fwd(const void* y, const void* e, const int* labels,
                            int N, int V, int D, float* out_lse,
                            float* out_label, float* out_max, void* stream) {
  return (int)dispatch_d<FWD>(D, y, e, labels, nullptr, nullptr, N, V, out_lse,
                              out_label, out_max, nullptr,
                              static_cast<cudaStream_t>(stream));
}

// -> dY [N, D] bf16
extern "C" int edl_xent_dy(const void* y, const void* e, const int* labels,
                           const float* lse, const float* row_scale, int N,
                           int V, int D, void* dy, void* stream) {
  return (int)dispatch_d<DY>(D, y, e, labels, lse, row_scale, N, V, nullptr,
                             nullptr, nullptr, dy,
                             static_cast<cudaStream_t>(stream));
}
