// Staging helpers of the Hopper kernels that move tiles by TMA: K1's
// backward (flash_attention_bwd.cu), the fused K2 forward (ssm_scan.cu) and
// K2's backward (ssm_scan_bwd.cu).  mbarriers with a wait that traps, TMA
// loads and stores of tensor-map boxes, a plain bulk copy, the host-side
// encoder of tensor maps (cuTensorMapEncodeTiled, looked up in the libcuda
// the runtime has loaded, so these libraries need no link against libcuda),
// the shared-memory opt-in, and K2's packed rows of a staged tile.
#pragma once
#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hopper {

constexpr long long WAIT_LIMIT = 1ll << 33;  // cycles (seconds) before a wait traps

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) & ~127; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
      :: "r"(smem_u32(bar))
      : "memory");
}
// Arrive, and expect `bytes` more of TMA traffic before the phase completes.
__device__ __forceinline__ void bar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
      :: "r"(smem_u32(bar)), "r"(bytes)
      : "memory");
}
// Wait until the phase of parity `parity` has completed.  A wait that lasts
// seconds is a fault: trap, so the launch fails instead of hanging.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > WAIT_LIMIT) __trap();
  }
}

// A box (cols, rows, 1) of a 3-D tensor map at (col, row, batch), counted
// on `bar`.  Out-of-range elements arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(col), "r"(row), "r"(batch)
      : "memory");
}
// A 4-D box (d, head, seq, batch) of a tensor map into shared memory,
// counted on `bar`; and back out of shared memory (tma_store_4d).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int d, int h, int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(d), "r"(h), "r"(s), "r"(b)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int d,
                                             int h, int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(d), "r"(h), "r"(s), "r"(b)
      : "memory");
}
// Commit the stores issued so far and wait until they have read shared memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned), counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(smem_u32(bar))
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// The tensor map of a (B, S, cols) tensor whose rows are `row_stride`
// elements apart (batches S rows apart), in boxes of (box_cols, box_rows, 1)
// elements.  dtype: 0 = float32, 1 = bfloat16.  TMA needs a 16-byte aligned
// base, 16-byte row strides and box rows of a multiple of 16 bytes (the
// wrapper checks the first two; the plan makes the third).  Returns 0 or -4.
inline int tensor_map_rows(CUtensorMap* map, int dtype, const void* base, long long cols,
                           long long row_stride, long long S, long long B, int box_cols,
                           int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -4;
  const long long es = dtype == 1 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)(row_stride * es), (cuuint64_t)(row_stride * S * es)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
      const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of range: zeros
  return r == CUDA_SUCCESS ? 0 : -4;
}

// Opens `bytes` of dynamic shared memory to `kernel` (above the 48 KB
// default).  With `done`, a bit a device records that this kernel's
// constant size is open there already, so later launches skip the call.
// Returns 0 or the cudaError_t.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, unsigned long long* done = nullptr) {
  if (bytes <= 48 * 1024) return 0;
  unsigned long long bit = 0;
  if (done != nullptr) {
    int dev = 0;
    const cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    bit = 1ull << (dev & 63);
    if (*done & bit) return 0;
  }
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && done != nullptr) *done |= bit;
  return (int)err;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// NL values of T (float or bfloat16) of a row in shared memory, loaded in
// vectors of up to 16 bytes (the row aligned to its size) and kept packed
// as they are: each is converted to f32 where it is used, so the raw row
// costs NL / 2 registers in bf16.
template <typename T, int NL>
struct Row {
  static constexpr int BYTES = NL * (int)sizeof(T);
  static constexpr int WORDS = (BYTES + 3) / 4;
  uint32_t w[WORDS];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (BYTES % 16 == 0) {
#pragma unroll
      for (int k = 0; k < BYTES / 16; ++k) {
        const uint4 q = reinterpret_cast<const uint4*>(p)[k];
        w[4 * k] = q.x, w[4 * k + 1] = q.y, w[4 * k + 2] = q.z, w[4 * k + 3] = q.w;
      }
    } else if constexpr (BYTES == 8) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      w[0] = q.x, w[1] = q.y;
    } else if constexpr (BYTES == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }
  __device__ __forceinline__ float operator[](int i) const {
    if constexpr (sizeof(T) == 4) return __uint_as_float(w[i]);
    return __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);  // bf16: exact
  }
};

// A Row's NL values, loaded and converted to f32 at once.
template <typename T, int NL>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[NL]) {
  Row<T, NL> r;
  r.load(p);
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] = r[i];
}

}  // namespace hopper
