// Flash-attention forward for Hopper (sm_90a): O and the per-row
// logsumexp of softmax(scale * Q K^T) V, causal or with a [B, Tk] key
// mask, without the [T, T] score matrix ever reaching device memory.
//
// Replaces the TPU kernel edl_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd_3d).  Same function, designed for the card
// rather than copied tile by tile.
//
// What bounds it.  At the long-context shape ([1, 32768, 12, 64],
// causal) the function is 4*B*H*D*T*(T+1)/2 = 2.06e12 FLOP, 1.67 ms at
// 989 TFLOP/s dense bf16, against 201 MB of Q/K/V/O, 0.06 ms at 3.35
// TB/s: compute-bound at every shape the port runs.  So the design keeps
// the tensor cores fed and everything else out of their way:
//
// - One block per (batch*head, Q tile): consumer warpgroups of 64 query
//   rows each, and a producer warpgroup whose one thread starts every
//   load; setmaxnreg gives the producer's registers to the consumers.
//   At D <= 64 three consumers (192-row Q tiles, 160 registers each
//   against the producer's 32): while one warpgroup runs its softmax,
//   the other two keep the tensor cores busy (faster than two on the
//   H100 at the training shapes, in spite of a few spilled registers;
//   PERF.md).  At D = 128 two (128 rows, 232 registers
//   against 40), as the larger O accumulator needs.
// - Loads are TMA tiles ([rows, D] boxes of the strided [B, T, H, D]
//   operand, swizzled for wgmma, see hopper.cuh).  Q is loaded once;
//   K and V tiles of 128 keys go through a 2-stage ring of mbarriers
//   (K and V with barriers of their own, so S = Q K^T starts before V
//   has landed), so the next tile's load overlaps this tile's products.
// - S = Q K^T is one wgmma m64n128 per k16 step into registers (A = Q,
//   B = K, both K-major in shared memory).  The online softmax runs on
//   the accumulator fragment (each thread holds 2 rows x 32 keys; row
//   max and sum in f32 registers, quad shuffles), in base 2 with the
//   scale folded into one multiply.
// - P is cast to the input type in registers (the TPU kernel's
//   p.astype(vb.dtype)) and is the register A operand of O += P V
//   (B = V, MN-major through the descriptor's transpose bit).  The f32 O
//   accumulator stays in registers for the whole K loop.
// - Causal: K tiles wholly above the diagonal are never loaded; only
//   tiles that cross it (or the ragged end of Tk, or a key mask) pay the
//   per-element mask.  Q tiles are scheduled with the most work first.
// - Ragged T: TMA reads zeros past the sequence's end; those keys are
//   masked, those query rows are not written.  A fully masked row gives
//   O = 0 and lse = log(1e-30), as _safe and l_safe do in the TPU
//   kernel.  No atomics: the output is deterministic.
// - O is written contiguous [B, Tq, H, D], lse contiguous [B, H, Tq]
//   float32.  Q, K and V are read in place through their strides (the
//   slices of a fused QKV projection need no copy).
//
// Shared memory at D = 64: Q 24 KB + 2 x (K 16 KB + V 16 KB) = 88 KB.

#include "hopper.cuh"

namespace {

constexpr int BN = 128;  // keys per K/V tile
constexpr int STAGES = 2;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// _safe: a row max still at NEG_INF (nothing attended yet) counts as 0,
// so exp(NEG_INF - 0) == 0 rather than exp(0) == 1.
__device__ __forceinline__ float safe_max(float m) {
  return m <= NEG_INF * 0.5f ? 0.f : m;
}

// Shared-memory layout: every tile is D / PW panels of [rows, PW] (see
// hopper.cuh), every region 1024-byte aligned.
template <int D, int CONS>
struct Layout {
  // CONS consumer warpgroups of 64 query rows and one producer
  // warpgroup; setmaxnreg splits the 64K registers of the SM between
  // them (128 * PRODUCER_REGS + 128 * CONS * CONSUMER_REGS <= 65536)
  static constexpr int CONSUMERS = CONS;
  static constexpr int BM = 64 * CONS;  // query rows per block
  static constexpr int NTHREADS = 128 * (CONS + 1);
  static constexpr int PRODUCER_REGS = CONS == 2 ? 40 : 32;
  static constexpr int CONSUMER_REGS = CONS == 2 ? 232 : 160;
  static constexpr int PW = D < 64 ? D : 64;  // panel columns
  static constexpr int NP = D / PW;           // panels
  static constexpr int ROW_BYTES = PW * 2;
  static constexpr int KPP = PW / 16;         // k16 steps per panel
  static constexpr size_t q_panel = size_t(BM) * ROW_BYTES;
  static constexpr size_t kv_panel = size_t(BN) * ROW_BYTES;
  static constexpr size_t q_bytes = q_panel * NP;
  static constexpr size_t kv_bytes = kv_panel * NP;  // one K or V tile
  static constexpr size_t k_off = q_bytes;
  static constexpr size_t v_off = k_off + STAGES * kv_bytes;
  static constexpr size_t bar_off = v_off + STAGES * kv_bytes;
  // 7 barriers, and slack to align the dynamic buffer to 1024 bytes
  static constexpr size_t total = bar_off + 64 + 1024;
};

struct FwdArgs {
  const uint8_t* kv_mask;  // [B, Tk] or null
  void* o;                 // [B, Tq, H, D]
  float* lse;              // [B, H, Tq]
  int H, Tq, Tk;
  float scale_log2;        // scale * log2(e)
  int causal;
};

template <typename T, int D, int CONS>
__global__ void __launch_bounds__(Layout<D, CONS>::NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const FwdArgs a) {
  using L = Layout<D, CONS>;
  constexpr int PW = L::PW;
  constexpr int NP = L::NP;
  constexpr int BM = L::BM;
  constexpr int CONSUMERS = L::CONSUMERS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;    // [STAGES]
  uint64_t* v_full = bars + 3;    // [STAGES]
  uint64_t* kv_empty = bars + 5;  // [STAGES]

  // warp-uniform to the compiler (a shuffle from lane 0), so branches on
  // it hold no wgmma in a divergent path
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  // Highest Q tiles first: under causal masking they carry the most K
  // tiles, so the long blocks start early and the short ones fill in.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  int n_kt = (a.Tk + BN - 1) / BN;
  if (a.causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], CONSUMERS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread starts every TMA load ----
    setmaxnreg_dec<L::PRODUCER_REGS>();
    if (tid == 0) {
      mbar_arrive_expect_tx(q_full, (uint32_t)L::q_bytes);
      for (int p = 0; p < NP; ++p) {
        tma_load_4d(smem + p * L::q_panel, &tm_q, q_full, p * PW, h, q0, b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        const int r = kt / STAGES;
        if (r > 0) mbar_wait(&kv_empty[s], (r - 1) & 1);
        unsigned char* sk = smem + L::k_off + s * L::kv_bytes;
        unsigned char* sv = smem + L::v_off + s * L::kv_bytes;
        mbar_arrive_expect_tx(&k_full[s], (uint32_t)L::kv_bytes);
        for (int p = 0; p < NP; ++p) {
          tma_load_4d(sk + p * L::kv_panel, &tm_k, &k_full[s], p * PW, h, kt * BN, b);
        }
        mbar_arrive_expect_tx(&v_full[s], (uint32_t)L::kv_bytes);
        for (int p = 0; p < NP; ++p) {
          tma_load_4d(sv + p * L::kv_panel, &tm_v, &v_full[s], p * PW, h, kt * BN, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    setmaxnreg_inc<L::CONSUMER_REGS>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int c = lane % 4;
    const int qw0 = q0 + 64 * wg;           // this warpgroup's first row
    const int row0 = qw0 + 16 * warp + g;   // this thread's rows: row0, row0 + 8
    const uint8_t* mrow = a.kv_mask ? a.kv_mask + (long long)b * a.Tk : nullptr;
    const unsigned char* sq = smem + 64 * wg * L::ROW_BYTES;

    float o[NP][PW / 2];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < PW / 2; ++i) o[p][i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};  // running row max, base-2 scaled
    float l[2] = {0.f, 0.f};          // this thread's part of the row sum

    mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      const uint32_t parity = (kt / STAGES) & 1;
      const int k0 = kt * BN;
      const unsigned char* sk = smem + L::k_off + s * L::kv_bytes;
      const unsigned char* sv = smem + L::v_off + s * L::kv_bytes;

      // S = Q K^T for this warpgroup's 64 rows and the tile's 128 keys
      float sacc[BN / 2];
      mbar_wait(&k_full[s], parity);
      fence_operand(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk / L::KPP;
        const int koff = (kk % L::KPP) * 32;
        wgmma_ss<T, 0, 0>(sacc, smem_desc(sq + p * L::q_panel + koff, L::ROW_BYTES),
                          smem_desc(sk + p * L::kv_panel + koff, L::ROW_BYTES), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(sacc);

      // online softmax on the fragment: sacc[4n + 2i + j] is row
      // row0 + 8i, key k0 + 8n + 2c + j
      const bool need_mask =
          (a.causal && k0 + BN - 1 > qw0) || (k0 + BN > a.Tk) || (mrow != nullptr);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qp = row0 + 8 * i;
        float tmax = NEG_INF;
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float x = sacc[4 * n + 2 * i + j] * a.scale_log2;
            if (need_mask) {
              const int kp = k0 + 8 * n + 2 * c + j;
              const bool keep = kp < a.Tk && (!a.causal || kp <= qp) &&
                                (mrow == nullptr || mrow[kp] != 0);
              if (!keep) x = NEG_INF;
            }
            sacc[4 * n + 2 * i + j] = x;
            tmax = fmaxf(tmax, x);
          }
        }
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(m[i], tmax);
        const float m_use = safe_max(m_new);
        // nothing attended before this tile: O and l are still 0
        const float alpha = m[i] <= NEG_INF * 0.5f ? 0.f : exp2f(m[i] - m_use);
        float psum = 0.f;
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float pv = exp2f(sacc[4 * n + 2 * i + j] - m_use);
            sacc[4 * n + 2 * i + j] = pv;
            psum += pv;
          }
        }
        l[i] = l[i] * alpha + psum;
        m[i] = m_new;
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int n = 0; n < PW / 8; ++n) {
            o[p][4 * n + 2 * i] *= alpha;
            o[p][4 * n + 2 * i + 1] *= alpha;
          }
      }

      // P in the input type, as the register A fragment of P V
      uint32_t pf[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int qd = 0; qd < 4; ++qd)
          pf[kk][qd] = pack2<T>(sacc[8 * kk + 2 * qd], sacc[8 * kk + 2 * qd + 1]);

      // O += P V
      mbar_wait(&v_full[s], parity);
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_operand(o[p]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          wgmma_rs<T, 1>(o[p], pf[kk],
                         smem_desc(sv + p * L::kv_panel + kk * 16 * L::ROW_BYTES,
                                   L::ROW_BYTES),
                         1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_operand(o[p]);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) fence_operand(pf[kk]);
      mbar_arrive(&kv_empty[s]);
    }

    // epilogue: O / l and lse for this thread's two rows
    T* out = static_cast<T*>(a.o);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int qp = row0 + 8 * i;
      if (qp >= a.Tq) continue;
      const float l_safe = fmaxf(li, 1e-30f);
      const float inv = 1.f / l_safe;
      T* orow = out + ((long long)(b * a.Tq + qp) * a.H + h) * D;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int n = 0; n < PW / 8; ++n) {
          *reinterpret_cast<uint32_t*>(orow + p * PW + 8 * n + 2 * c) =
              pack2<T>(o[p][4 * n + 2 * i] * inv, o[p][4 * n + 2 * i + 1] * inv);
        }
      if (c == 0) a.lse[(long long)bh * a.Tq + qp] = safe_max(m[i]) * LN2 + logf(l_safe);
    }
  }
}

template <typename T, int D, int CONS>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   const void* kv_mask, void* o, float* lse, int B, int H,
                   int Tq, int Tk, const long long* qs, const long long* ks,
                   const long long* vs, float scale, int causal,
                   cudaStream_t stream) {
  using L = Layout<D, CONS>;
  const int n_qt = (Tq + L::BM - 1) / L::BM;
  if (B * H == 0 || n_qt == 0) return cudaSuccess;
  CUtensorMap mq, mk, mv;
  cudaError_t err = encode_bthd_map(&mq, dtype, q, B, Tq, H, D, qs, L::PW, L::BM);
  if (err == cudaSuccess) err = encode_bthd_map(&mk, dtype, k, B, Tk, H, D, ks, L::PW, BN);
  if (err == cudaSuccess) err = encode_bthd_map(&mv, dtype, v, B, Tk, H, D, vs, L::PW, BN);
  if (err != cudaSuccess) return err;
  auto kern = flash_fwd_kernel<T, D, CONS>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::total);
  if (err != cudaSuccess) return err;
  FwdArgs a;
  a.kv_mask = static_cast<const uint8_t*>(kv_mask);
  a.o = o;
  a.lse = lse;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.scale_log2 = scale * LOG2E;
  a.causal = causal;
  kern<<<dim3(B * H, n_qt), L::NTHREADS, L::total, stream>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

// Three consumer warpgroups (192 query rows) where the head dim leaves
// room in 160 registers a thread, two (128 rows, 232 registers) at D = 128.
template <typename T, int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   const void* kv_mask, void* o, float* lse, int B, int H,
                   int Tq, int Tk, const long long* qs, const long long* ks,
                   const long long* vs, float scale, int causal,
                   cudaStream_t stream) {
  return launch<T, D, D <= 64 ? 3 : 2>(dtype, q, k, v, kv_mask, o, lse, B, H, Tq, Tk,
                                       qs, ks, vs, scale, causal, stream);
}

template <typename T>
cudaError_t dispatch_d(int dtype, int D, const void* q, const void* k,
                       const void* v, const void* kv_mask, void* o, float* lse,
                       int B, int H, int Tq, int Tk, const long long* qs,
                       const long long* ks, const long long* vs, float scale,
                       int causal, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(dtype, q, k, v, kv_mask, o, lse, B, H, Tq, Tk, qs, ks,
                           vs, scale, causal, stream);
    case 32:
      return launch<T, 32>(dtype, q, k, v, kv_mask, o, lse, B, H, Tq, Tk, qs, ks,
                           vs, scale, causal, stream);
    case 64:
      return launch<T, 64>(dtype, q, k, v, kv_mask, o, lse, B, H, Tq, Tk, qs, ks,
                           vs, scale, causal, stream);
    case 128:
      return launch<T, 128>(dtype, q, k, v, kv_mask, o, lse, B, H, Tq, Tk, qs, ks,
                            vs, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (loaded with ctypes).  dtype: 0 = bf16, 1 = f16.
// *_strides: {batch, sequence, head} strides of q/k/v in elements
// (multiples of 8; the last dim is contiguous, the base 16-byte
// aligned).  kv_mask: [B, Tk] bytes, 0 = masked, or NULL.  Encodes the
// TMA maps, launches on `stream` and returns the first cudaError_t.
extern "C" int edl_flash_fwd(int dtype, const void* q, const void* k,
                             const void* v, const void* kv_mask, void* o,
                             float* lse, int B, int H, int Tq, int Tk, int D,
                             const long long* q_strides,
                             const long long* k_strides,
                             const long long* v_strides, float scale,
                             int causal, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)dispatch_d<__nv_bfloat16>(dtype, D, q, k, v, kv_mask, o, lse, B, H,
                                          Tq, Tk, q_strides, k_strides, v_strides,
                                          scale, causal, st);
  }
  if (dtype == 1) {
    return (int)dispatch_d<__half>(dtype, D, q, k, v, kv_mask, o, lse, B, H, Tq, Tk,
                                   q_strides, k_strides, v_strides, scale, causal,
                                   st);
  }
  return (int)cudaErrorInvalidValue;
}
