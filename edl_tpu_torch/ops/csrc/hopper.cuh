// Hopper (sm_90a) building blocks shared by every kernel of the port:
// the flash-attention forward (flash_fwd.cu, B1), both flash-attention
// backwards (flash_bwd.cu, B2; flash_bwd_streamk.cu, B3) and the fused
// cross entropy's statistics and gradients (xent_fwd.cu, B4; xent_dy.cu,
// B5; xent_de.cu, B6).  Each includes this header in its own translation
// unit; nothing here has external linkage.
//
// - mbarrier: init, arrive, arrive + expect-tx, wait on a phase parity
//   (with a watchdog that traps instead of hanging forever);
// - TMA: 4-D tiled loads (cp.async.bulk.tensor) from a CUtensorMap kept
//   in the kernel's parameter space (const __grid_constant__), and the
//   host-side encoding of such a map over a strided [B, T, H, D]
//   operand.  cuTensorMapEncodeTiled lives in libcuda, not in the
//   runtime; it is looked up at run time (cudaGetDriverEntryPoint), so
//   the library links against the runtime alone (no -lcuda);
// - wgmma: the shared-memory matrix descriptor of a tile that TMA wrote
//   with the 32/64/128-byte swizzle of its row length, fence / commit /
//   wait, operand fences, and m64nNk16 products with both operands in
//   shared memory (wgmma_ss) or A in registers (wgmma_rs);
// - fence.proxy.async, named barriers, setmaxnreg.
//
// Tile layout used by every kernel: an operand tile of R rows and D
// columns (16-bit) is stored as D / PW column panels of PW = min(D, 64)
// columns, each panel R rows of PW * 2 bytes (32, 64 or 128), swizzled
// by TMA with the swizzle of that row length and 1024-byte aligned.  The
// same tile serves wgmma as a K-major operand (rows = M or N, columns =
// K) and as an MN-major one (rows = K, columns = M or N, the transpose
// bit set), because every product here keeps M or N of an MN-major
// operand within one panel.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---- shared memory, barriers ---------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barrier inits visible to the async proxy (TMA); follow with
// __syncthreads before any thread uses the barriers.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also expects `bytes` of TMA transactions this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

//: a wait on one barrier phase longer than this is a pipeline bug (the
//: longest legitimate wait is one block's Q sweep, milliseconds)
constexpr uint64_t MBAR_WATCHDOG_NS = 10ull * 1000 * 1000 * 1000;

// Wait until the phase of parity `parity` of `bar` has completed.  A
// phase bug would hang the card; past MBAR_WATCHDOG_NS the kernel traps,
// so the launch fails with an error instead.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (start == 0) {
      start = now;
    } else if (now - start > MBAR_WATCHDOG_NS) {
      __trap();
    }
  }
}

// Generic-proxy writes to shared memory (st.shared) become visible to
// the async proxy (wgmma operand reads, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bar.sync on hardware barrier `id` (1..15; 0 is __syncthreads) among
// `count` threads (a multiple of 32).
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- TMA -------------------------------------------------------------------

// Load the box at coordinates (c0 = column, c1 = head, c2 = row,
// c3 = batch) of a 4-D map into `dst`; completion counts its bytes on
// `bar`.  Coordinates past the tensor's end read as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime already loaded.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Encode a map over a [B, T, H, D] operand of 16-bit elements (dtype 0 =
// bf16, 1 = f16) whose {batch, sequence, head} strides are `strides`
// elements (multiples of 8) and whose last dim is contiguous: dims
// (D, H, T, B), box (box_cols, 1, box_rows, 1), the swizzle of a
// box_cols * 2 byte row (32, 64 or 128), zeros past every end.
inline cudaError_t encode_bthd_map(CUtensorMap* map, int dtype, const void* ptr,
                                   int B, int T, int H, int D,
                                   const long long* strides, int box_cols,
                                   int box_rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t byte_strides[3] = {(cuuint64_t)strides[2] * 2,
                                      (cuuint64_t)strides[1] * 2,
                                      (cuuint64_t)strides[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1u, (cuuint32_t)box_rows, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  const int row_bytes = box_cols * 2;
  const CUtensorMapSwizzle swizzle =
      row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = encode(
      map,
      dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(ptr), dims, byte_strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- wgmma -----------------------------------------------------------------

// Descriptor of a swizzled tile region starting at `p` whose rows are
// `row_bytes` long (32, 64 or 128: the swizzle TMA wrote it with).  Both
// strides are set to one 8-row group (8 * row_bytes): the stride
// between 8-row groups of a K-major operand, and between the two 8-row
// K groups of a k16 step of an MN-major one; the stride along M/N of an
// MN-major operand is never used, as no product here crosses a panel.
// Stepping along K inside a K-major row is `p` + 32 bytes per k16 step.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t row_bytes) {
  const uint64_t group = (8u * row_bytes) >> 4;
  const uint64_t mode = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (group << 16) |
         (group << 32) | (mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma operand
// registers across the asynchronous product: call on the accumulators
// (and register A operands) before the product starts and after the
// wait that completes it.
template <int N>
__device__ __forceinline__ void fence_operand(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operand(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Two floats as one 32-bit register of two 16-bit values, `lo` in the
// low half: the register A fragment's element pairs.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator fragment of m64nNk16 (f32), thread t of the warpgroup:
// d[4n + 2i + j] is row 16 * (t / 32) + (t % 32) / 4 + 8 i, column
// 8 n + 2 (t % 4) + j.  The register A fragment of a k16 step kk is the
// accumulator's columns 16 kk .. 16 kk + 15 in the same threads:
// a[q] = pack2(d[8 kk + 2 q], d[8 kk + 2 q + 1]), q = 0..3.

// ---- wgmma m64nNk16 with f32 accumulators: N = 2 x the length of d ----
// One asm statement per shape, written out once for both 16-bit types:
// TY is the PTX type of A and B ("bf16" or "f16").  TA, TB are the
// transpose bits of an MN-major A or B in shared memory.

#define EDL_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define EDL_ACC8(i) EDL_ACC4(i), EDL_ACC4(i + 4)
#define EDL_ACC16(i) EDL_ACC8(i), EDL_ACC8(i + 8)
#define EDL_ACC32(i) EDL_ACC16(i), EDL_ACC16(i + 16)
#define EDL_ACC64(i) EDL_ACC32(i), EDL_ACC32(i + 32)
#define EDL_MMA(N, TY) "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "
#define EDL_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}, "
#define EDL_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
#define EDL_REGS32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
#define EDL_REGS64                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "      \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "      \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "

// A and B from shared memory; P is the operand number of scale_d.
#define EDL_WGMMA_SS(N, TY, REGS, ACC, P, A, B, TA_, TB_)                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n" EDL_MMA(N, TY) REGS      \
               "%" #A ", %" #B ", p, 1, 1, %" #TA_ ", %" #TB_ ";\n}\n"                      \
               : ACC                                                                       \
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
// A in four registers, B from shared memory.
#define EDL_WGMMA_RS(N, TY, REGS, ACC, A0, A1, A2, A3, B, P, TB_)                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n" EDL_MMA(N, TY) REGS      \
               "{%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B ", p, 1, 1, %" #TB_        \
               ";\n}\n"                                                                    \
               : ACC                                                                       \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),      \
                 "n"(TB))

template <typename T>
__host__ __device__ constexpr bool is_bf16() {
  static_assert(std::is_same<T, __nv_bfloat16>::value || std::is_same<T, __half>::value,
                "wgmma operands are bf16 or f16");
  return std::is_same<T, __nv_bfloat16>::value;
}

template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (is_bf16<T>()) {
    EDL_WGMMA_SS(16, "bf16", EDL_REGS8, EDL_ACC8(0), 10, 8, 9, 11, 12);
  } else {
    EDL_WGMMA_SS(16, "f16", EDL_REGS8, EDL_ACC8(0), 10, 8, 9, 11, 12);
  }
}

template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (is_bf16<T>()) {
    EDL_WGMMA_SS(32, "bf16", EDL_REGS16, EDL_ACC16(0), 18, 16, 17, 19, 20);
  } else {
    EDL_WGMMA_SS(32, "f16", EDL_REGS16, EDL_ACC16(0), 18, 16, 17, 19, 20);
  }
}

template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (is_bf16<T>()) {
    EDL_WGMMA_SS(64, "bf16", EDL_REGS32, EDL_ACC32(0), 34, 32, 33, 35, 36);
  } else {
    EDL_WGMMA_SS(64, "f16", EDL_REGS32, EDL_ACC32(0), 34, 32, 33, 35, 36);
  }
}

template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (is_bf16<T>()) {
    EDL_WGMMA_SS(128, "bf16", EDL_REGS64, EDL_ACC64(0), 66, 64, 65, 67, 68);
  } else {
    EDL_WGMMA_SS(128, "f16", EDL_REGS64, EDL_ACC64(0), 66, 64, 65, 67, 68);
  }
}

template <typename T, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  if constexpr (is_bf16<T>()) {
    EDL_WGMMA_RS(16, "bf16", EDL_REGS8, EDL_ACC8(0), 8, 9, 10, 11, 12, 13, 14);
  } else {
    EDL_WGMMA_RS(16, "f16", EDL_REGS8, EDL_ACC8(0), 8, 9, 10, 11, 12, 13, 14);
  }
}

template <typename T, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  if constexpr (is_bf16<T>()) {
    EDL_WGMMA_RS(32, "bf16", EDL_REGS16, EDL_ACC16(0), 16, 17, 18, 19, 20, 21, 22);
  } else {
    EDL_WGMMA_RS(32, "f16", EDL_REGS16, EDL_ACC16(0), 16, 17, 18, 19, 20, 21, 22);
  }
}

template <typename T, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  if constexpr (is_bf16<T>()) {
    EDL_WGMMA_RS(64, "bf16", EDL_REGS32, EDL_ACC32(0), 32, 33, 34, 35, 36, 37, 38);
  } else {
    EDL_WGMMA_RS(64, "f16", EDL_REGS32, EDL_ACC32(0), 32, 33, 34, 35, 36, 37, 38);
  }
}

}  // namespace
