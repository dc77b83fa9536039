// Flash attention backward for Hopper (sm_90a): the gradient of K1.
//
// The JAX package has no backward kernel: its Pallas kernel
// `flash_attention_kernel` (src/repro/kernels/flash_attention.py) is forward
// only, and JAX differentiates the plain `repro.models.layers.flash_attention`
// (src/repro/models/layers.py:115) by autodiff.  The port puts K1's forward on
// the training path, so its gradient is a kernel too.
//
// Semantics: with s = q.k^T/sqrt(D) over the valid keys (causal, window and
// Skv masks as in the forward), P = softmax(s) and O = P V,
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Delta),  Delta = rowsum(dO o O),
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D),
// with dK and dV summed over the q heads of each GQA group.  P is recomputed
// from the forward's log-sum-exp (flash_attention.cu writes it in base 2:
// P = exp2(s * log2(e) - lse)); a row with no valid key (lse = -inf) has
// P = 0 and gets no gradient.
//
// FlashAttention-2's backward, three kernels, no atomics (deterministic):
//
//  * flash_bwd_preprocess_kernel: Delta = rowsum(dO o O) in f32, a warp a row.
//  * flash_bwd_dkdv_kernel (bf16): one block per (b, kv head, 128 keys), two
//    warpgroups of 64 keys, each keeping its keys' dK and dV in f32
//    registers for the whole walk.  K and V arrive once by TMA; then the
//    block walks the q heads of the group one after the other and, for
//    each, the tiles of 64 query positions that see one of its keys: Q and
//    dO tiles by TMA, the tile's log-sum-exp and Delta by plain loads,
//    through a 4-stage ring of mbarrier full/empty pairs.  Per tile, S^T =
//    K Q^T and dP^T = V dO^T by wgmma from shared memory (m64n64k16), P^T
//    and dS^T on the accumulators, then dV += P^T dO and dK += dS^T Q by
//    wgmma with A from registers (the accumulators rounded to bf16) and dO
//    or Q read through the transpose bit, so Q and dO land once in one
//    layout for both uses.  A tile's dV and dK products complete behind the
//    next tile's S^T and dP^T, so the tensor cores keep work queued.  The
//    GQA sum is the walk, so no block writes another's keys.  The epilogue
//    stages bf16 dK and dV in the warpgroup's own K and V tiles and stores
//    them by TMA, which clips keys past Skv.
//  * flash_bwd_dq_kernel (bf16): one block per (b, q head, 128 positions),
//    two warpgroups of 64 positions: Q and dO by TMA once, K/V tiles of 64
//    keys of its kv head through the ring; S = Q K^T, dP = dO V^T, dS, then
//    dQ += dS K (K through the transpose bit), pipelined as above.  Heaviest
//    causal blocks first.  It recomputes S and dP: fusing dQ into the dK/dV
//    walk would need atomics or an ordering between blocks to stay
//    deterministic.
//
// No producer warpgroup: warp 0 (dK/dV) or thread 0 (dQ) of the first
// warpgroup also keeps the ring full, refilling the stage of the tile
// before the one it starts once both warpgroups have released it.  With a
// third warpgroup, 384 threads a block leave ptxas 168 registers a thread,
// and `setmaxnreg` did not raise what it allocates for the consumers: the
// dK/dV consumer (192 accumulator registers) spilled and its wgmma were
// serialized.  Two warpgroups take up to 255 (PERF.md has the numbers).
//
// The walks are those of `bwd_plan` in kernels/flash_attention.py: a
// warpgroup visits the 64-wide tiles that hold a position (dK/dV) or key
// (dQ) that sees, or is seen by, one of its rows, and evaluates masks only on
// tiles that cross the causal diagonal, the window's edge, Sq or Skv.  A
// block loads the union of its two warpgroups' tiles; a warpgroup skips a
// tile outside its own walk.  TMA fills positions past Sq and keys past Skv
// with zeros; positions past Sq get lse = +inf and Delta = 0, so their P and
// dS are 0.
//
// Shared memory: every operand tile is 64 rows x D in column blocks of the
// swizzle's width (128 bytes for D >= 64, 64 for D = 32, 32 for D = 16), the
// layout both TMA's swizzle and wgmma's descriptors name.  At D = 128 the
// dK/dV kernel holds K and V (64 KB) and four stages of Q and dO (128 KB),
// the dQ kernel Q and dO (64 KB) and four stages of K and V (128 KB): one
// block of 256 threads per SM.  D = 80 (zamba2) keeps the 128-byte swizzle
// and the tiles of D = 128: its 160-byte rows take two column blocks, the
// second's last 48 columns zero (TMA's fill), so the products over D take
// 5 k-steps of 16 with no padding, those with D as N are m64n80k16 (40
// accumulators a thread) reading the second block through the descriptor's
// leading byte offset, and the epilogue's stores clip the padding.
// What bounds it: 5 products of 2.B.H.Sq.Skv.D flops (halved by a causal
// mask) against reading q, k, v, o, dO once and writing dq, dk, dv once; at
// qwen3's training shape (B 8, S 1024, 16/8 heads, D 128) that is 86 GFLOP
// against 0.2 GB, so the tensor cores' rate bounds it.  The kernels do 7
// products (dQ recomputes S and dP); PERF.md has their times.
//
// D = 256 (gemma3) takes kernels of its own, flash_bwd_dkdv_wide_kernel and
// flash_bwd_dq_wide_kernel: there a warpgroup's two 64 x 256 f32
// accumulators (dK and dV, 256 registers a thread) do not fit, nor do the
// tiles above (384 KB of shared memory for dK/dV).  A block owns one tile
// of 64 keys (dK/dV) or positions (dQ), and its two warpgroups split the
// work by product rather than by row: warpgroup 0 computes S^T = K Q^T
// (dQ: S = Q K^T) and P, warpgroup 1 dP^T = V dO^T (dQ: dP = dO V^T), each
// contracting all 256 columns by wgmma from shared memory; warpgroup 1
// hands dP over in f32 through shared memory, warpgroup 0 forms dS = P o
// (dP - Delta) and writes P and dS as bf16 64 x 64 tiles; then each
// warpgroup accumulates its half of D of dV += P^T dO and dK += dS^T Q
// (dQ: dQ += dS K) by m64n128k16 with both operands in shared memory, 64
// accumulator registers a product, so no product is done twice.  Named
// barriers order the two hand-offs.  K and V (dK/dV) or Q and dO (dQ)
// stay resident (64 KB), the walked tiles go through a 2-stage ring (128
// KB), the exchange takes 32 KB (dQ 24 KB); warp 0 of warpgroup 1, which
// waits while warpgroup 0 forms dS, keeps the ring full.  At gemma3's
// training shape (B 2, S 4096, 8/4 heads) the 5 products are 344 GFLOP
// causal and 150 with its 1024-key window, against 0.2 GB: the tensor
// cores' rate bounds it there too.
//
// f32 (the smoke configurations and the checks) takes plain FMA kernels with
// every tile in shared memory: flash_bwd_dkdv_fma_kernel and
// flash_bwd_dq_fma_kernel, 64 keys or rows a block (32 at D = 256, where
// tiles of 64 rows of D + 1 floats would not fit) and query rows (query
// position, q head of the group) interleaved, 32 a tile.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "tma.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int NT = 128;   // threads per block of the preprocess and FMA kernels
constexpr int BQ = 32;    // FMA: query rows per tile of the dK/dV kernel
// FMA: keys per dK/dV block, query rows per dQ block and keys per kv tile
// of the dQ kernel; 32 at D = 256, where tiles of 64 rows would not fit.
template <int D>
constexpr int fma_rows() {
  return D > 128 ? 32 : 64;
}
constexpr float LOG2E = 1.4426950408889634f;

// The tensor-core kernels: two warpgroups of 64 rows each, up to 255
// registers a thread (two warps per SM sub-partition).
constexpr int WG = 128;               // threads per warpgroup
constexpr int TC_THREADS = 2 * WG;
constexpr int ROWS = 64;              // rows of every operand tile
constexpr int BLOCK_ROWS = 2 * ROWS;  // keys (dK/dV) or positions (dQ) a block
constexpr int STAGES = 4;             // the ring of walked tiles

// Element strides (batch, seq, head) of one (B, S, heads, D) tensor.
struct Stride {
  long long b, s, h;
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  const float* lse;  // (B, H, Sq), base 2
  float* delta;      // (B, H, Sq)
  Stride sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, Sq, Skv, H, Hkv, group, causal, window, q_offset;
  float scale;
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Row r of a kv head's query rows (FMA kernels) is query position r / group
// of q head hk * group + r % group.
template <typename T>
__device__ __forceinline__ const T* row_ptr(const void* base, const Stride& s, int b, int hk,
                                            int group, int r) {
  return static_cast<const T*>(base) + b * s.b + (long long)(r / group) * s.s +
         (long long)(hk * group + r % group) * s.h;
}
__device__ __forceinline__ long long stat_index(const Args& a, int b, int hk, int r) {
  return ((long long)b * a.H + hk * a.group + r % a.group) * a.Sq + r / a.group;
}
// The log-sum-exp a tile uses: +inf for a padding row or a row with no valid
// key, so that exp2(s - lse) is 0 there.
__device__ __forceinline__ float tile_lse(const Args& a, int b, int hk, int r, int r_end) {
  const float l = r < r_end ? a.lse[stat_index(a, b, hk, r)] : INFINITY;
  return l == -INFINITY ? INFINITY : l;
}

// -------------------------------------------- Hopper: fences, barriers --
// Generic-proxy writes to shared memory, made visible to TMA and wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// A barrier of one warpgroup (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(WG) : "memory");
}
// A barrier of both warpgroups (ids 3 and 4, the D = 256 kernels' hand-offs):
// one side arrives without waiting, the other waits for it.
__device__ __forceinline__ void block_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(TC_THREADS) : "memory");
}
__device__ __forceinline__ void block_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(TC_THREADS) : "memory");
}

// ------------------------------------------------------------------ wgmma --
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
// Keep the compiler from moving reads or writes of accumulators across the
// asynchronous products that own them.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, f32) = A (64 x 16) . B^T (64 x 16), both K-major in shared
// memory: the first k-step of a product (d is only written).
__device__ __forceinline__ void wgmma_ss64_init(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(a), "l"(b), "r"(0));
}

// d (64 x 64, f32) += A (64 x 16) . B^T (64 x 16), the later k-steps.
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x N, f32) += A (64 x 16, bf16 fragments in registers) . B (16 x N),
// B MN-major in shared memory (read through the transpose bit).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) = A (64 x 16) . B (16 x 128), plus d where `add` is
// nonzero; both operands in shared memory, A K-major, B MN-major (the
// transpose bit).
__device__ __forceinline__ void wgmma_ss128_mn(float* d, uint64_t a, uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(add));
}

// ------------------------------------------------------------- preprocess --
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_preprocess_kernel(Args a) {
  const long long row = ((long long)blockIdx.x * NT + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.B * a.Sq * a.H) return;
  const int h = row % a.H;
  const int i = (row / a.H) % a.Sq;
  const int b = row / ((long long)a.H * a.Sq);
  const T* o = static_cast<const T*>(a.o) + b * a.so.b + (long long)i * a.so.s + h * a.so.h;
  const T* d = static_cast<const T*>(a.dout) + b * a.sdo.b + (long long)i * a.sdo.s + h * a.sdo.h;
  float sum = 0.f;
  for (int c = lane; c < D; c += 32) sum = fmaf(to_f(o[c]), to_f(d[c]), sum);
  sum = warp_sum(sum);
  if (lane == 0) a.delta[((long long)b * a.H + h) * a.Sq + i] = sum;
}

// The query rows [r_lo, r_hi) of a kv head that can see a key of [j0, j0 + nk).
__device__ __forceinline__ void rows_seeing(const Args& a, int j0, int nk, int* r_lo, int* r_hi) {
  int p_lo = 0, p_hi = a.Sq;  // query positions
  if (a.causal) p_lo = max(0, j0 - a.q_offset);
  if (a.window >= 0) p_hi = min(p_hi, j0 + nk - 1 + a.window - a.q_offset);
  *r_lo = p_lo * a.group;
  *r_hi = max(p_hi, p_lo) * a.group;
}

// The keys [kv_begin, kv_end) that query positions [p0, p0 + nq) see, the
// first rounded down to a tile of BN.
template <int BN>
__device__ __forceinline__ void keys_seen(const Args& a, int p0, int nq, int* kv_begin,
                                          int* kv_end) {
  const int q_lo = a.q_offset + p0, q_hi = q_lo + nq - 1;
  *kv_end = a.causal ? min(a.Skv, q_hi + 1) : a.Skv;
  *kv_begin = (a.window >= 0 ? max(0, q_lo - a.window + 1) : 0) / BN * BN;
}

__device__ __forceinline__ bool valid(const Args& a, int kv, int pos) {
  bool ok = kv < a.Skv;
  if (a.causal) ok = ok && kv <= pos;
  if (a.window >= 0) ok = ok && pos - kv < a.window;
  return ok;
}

// ------------------------------------------------ bf16 tiles and the walks --
// One operand tile: ROWS rows of D bf16 in column blocks of SW bytes a row,
// the swizzle's span; a block is ROWS * SW bytes, and the 16-byte chunks of
// a row are permuted by the row's place in 8 (CUTLASS's Swizzle<3,4,3> at
// 128 bytes), the layout TMA writes and wgmma reads.  A D that is no
// multiple of BOX (80: a 160-byte row) takes a last block that is partly
// past the tensor map's D columns: TMA fills those columns with zeros on a
// load, and still counts the whole box's bytes on the mbarrier, and clips
// them on a store.
template <int D>
struct Tile {
  static constexpr int SW = D >= 64 ? 128 : 2 * D;  // bytes a row of a column block
  static constexpr int BOX = SW / 2;                // elements a row of a column block
  static constexpr int BLOCKS = (D + BOX - 1) / BOX;  // column blocks
  static constexpr int BLOCK_BYTES = ROWS * SW;
  static constexpr int BYTES = BLOCKS * BLOCK_BYTES;
  static constexpr uint64_t MODE = SW == 128 ? 1 : SW == 64 ? 2 : 3;  // wgmma's swizzle code
};

template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | Tile<D>::MODE << 62;
}
// wgmma's view of k-step ks (16 of the D columns) of a tile whose rows are
// the product's M or N (K-major).
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  constexpr int PER = Tile<D>::SW / 32;  // k-steps per column block
  return smem_desc<D>(tile + (ks / PER) * Tile<D>::BLOCK_BYTES + (ks % PER) * 32, 16,
                      8 * Tile<D>::SW);
}
// wgmma's view of k-step ks (16 rows) of a tile whose D columns are the
// product's N (MN-major: the transpose bit).
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int ks) {
  return smem_desc<D>(tile + ks * 16 * Tile<D>::SW, Tile<D>::BLOCK_BYTES, 8 * Tile<D>::SW);
}
// Byte offset of element (r, c) of a tile.
template <int D>
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  using TL = Tile<D>;
  const uint32_t lin = (c / TL::BOX) * TL::BLOCK_BYTES + r * TL::SW + (c % TL::BOX) * 2;
  return lin ^ (((lin >> 7) & (TL::SW / 16 - 1)) << 4);
}

// A dK/dV warpgroup's walk: the tiles [lo, hi) of ROWS query positions that
// see one of the keys [j0, j0 + ROWS); lo == hi when none does.
__device__ __forceinline__ void dkdv_walk(const Args& a, int j0, int* lo, int* hi) {
  const int j1 = min(j0 + ROWS, a.Skv);
  int p_lo = a.causal ? max(0, j0 - a.q_offset) : 0;
  int p_hi = a.window >= 0 ? min(a.Sq, j1 - 1 + a.window - a.q_offset) : a.Sq;
  if (j0 >= j1 || (a.causal && a.window == 0) || p_lo >= p_hi) p_lo = p_hi = 0;
  *lo = p_lo / ROWS;
  *hi = (p_hi + ROWS - 1) / ROWS;
}
// A dQ warpgroup's walk: the tiles [lo, hi) of ROWS keys that one of the
// query positions [p0, p0 + ROWS) sees.
__device__ __forceinline__ void dq_walk(const Args& a, int p0, int* lo, int* hi) {
  const int p1 = min(p0 + ROWS, a.Sq);
  int k_lo = a.window >= 0 ? max(0, p0 + a.q_offset - a.window + 1) : 0;
  int k_hi = a.causal ? min(a.Skv, p1 + a.q_offset) : a.Skv;
  if (p0 >= p1 || (a.causal && a.window == 0) || k_lo >= k_hi) k_lo = k_hi = 0;
  *lo = k_lo / ROWS;
  *hi = (k_hi + ROWS - 1) / ROWS;
}
// The tiles a block loads: the union of its two warpgroups' walks.
__device__ __forceinline__ void block_walk(const int* lo, const int* hi, int* t_lo, int* n_t) {
  const bool e0 = lo[0] == hi[0], e1 = lo[1] == hi[1];
  *t_lo = e0 ? lo[1] : e1 ? lo[0] : min(lo[0], lo[1]);
  *n_t = max(hi[0], hi[1]) - *t_lo;
}
// No pair of ROWS positions from p0 and ROWS keys from k0 is masked.
__device__ __forceinline__ bool mask_free(const Args& a, int p0, int k0) {
  return p0 + ROWS <= a.Sq && k0 + ROWS <= a.Skv &&
         (!a.causal || k0 + ROWS - 1 <= p0 + a.q_offset) &&
         (a.window < 0 || p0 + ROWS - 1 + a.q_offset - k0 < a.window);
}

// A row with no valid key has lse = -inf; +inf makes its P 0, not NaN.
__device__ __forceinline__ float no_key(float lse) { return lse == -INFINITY ? INFINITY : lse; }

// The log-sum-exp and Delta of query positions p0 + lane and p0 + lane + 32
// of q head hq, as a tile uses them: +inf and 0 past Sq (padding: P = 0,
// dS = 0).
__device__ __forceinline__ void tile_stats(const Args& a, int b, int hq, int p0, int lane,
                                           float* l, float* d) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + lane + 32 * h;
    const long long at = ((long long)b * a.H + hq) * a.Sq + p;
    l[h] = p < a.Sq ? no_key(a.lse[at]) : INFINITY;
    d[h] = p < a.Sq ? a.delta[at] : 0.f;
  }
}

// x, opaque to the compiler: a descriptor built from it inside the walk is
// not hoisted out of it, where it would hold registers the whole way.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

template <int NS>
__device__ __forceinline__ void init_ring(uint64_t* once, int once_count, uint64_t* full,
                                          int full_count, uint64_t* empty) {
  if (threadIdx.x == 0) {
    bar_init(once, once_count);
    for (int s = 0; s < NS; ++s) {
      bar_init(&full[s], full_count);
      bar_init(&empty[s], 2 * WG / 32);  // each warp arrives once a tile
    }
    bar_init_fence();
  }
  __syncthreads();
}

// P = exp2(s log2(e) / sqrt(D) - lse) and dS = P (dP - Delta) on a 64 x 64
// pair of accumulators, then both rounded to the bf16 A fragments of the
// next products (k-step kk: columns [16 kk, 16 kk + 16)).  Row r of this
// lane's element e of block j is 16 warp + g + 8 (e / 2), its column
// 8 j + 2 t4 + e % 2; `lse` and `delta` give a row's or a column's value,
// `live` whether a pair is unmasked.
template <typename Lse, typename Delta, typename Live>
__device__ __forceinline__ void softmax_grad(float* s, float* dp, float sl2, Lse lse,
                                             Delta delta, Live live, uint32_t (*pa)[4],
                                             uint32_t (*da)[4]) {
  wgmma_wait<1>();
  fence_regs<32>(s);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(s[4 * j + e], sl2, -lse(j, e)));
      s[4 * j + e] = live(j, e) ? p : 0.f;
    }
  wgmma_wait<0>();
  fence_regs<32>(dp);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - delta(j, e));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
      da[kk][i] = pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
    }
}

// Write a 64 x N accumulator, times `mul`, as bf16 into columns [col0,
// col0 + N) of a tile of D columns; zeros instead with `none` (an
// accumulator no product has set).
template <int D, int N = D>
__device__ __forceinline__ void stage_tile(unsigned char* tile, const float* acc, float mul,
                                           int warp, int g, int t4, int col0 = 0,
                                           bool none = false) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(tile + tile_offset<D>(16 * warp + g + 8 * h,
                                                               col0 + 8 * j + 2 * t4)) =
          none ? __floats2bfloat162_rn(0.f, 0.f)
               : __floats2bfloat162_rn(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
}

// ------------------------------------------------------------ bf16 dK, dV --
struct DkvMaps {
  CUtensorMap q, dout, k, v, dk, dv;
};

template <int D>
struct DkvSmem {  // byte offsets from a 1024-aligned base
  static constexpr int T = Tile<D>::BYTES;
  static constexpr int K = 0, V = 2 * T, Q = 4 * T, DO = Q + STAGES * T;
  static constexpr int LSE = DO + STAGES * T, DELTA = LSE + STAGES * ROWS * 4;
  static constexpr int BARS = DELTA + STAGES * ROWS * 4;  // kv, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BARS + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ DkvMaps maps, const Args a) {
  using SM = DkvSmem<D>;
  using TL = Tile<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = align_1024(smem_raw);
  float* const s_lse = reinterpret_cast<float*>(smem + SM::LSE);  // [STAGES][ROWS]
  float* const s_delta = reinterpret_cast<float*>(smem + SM::DELTA);
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(smem + SM::BARS);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + STAGES;

  // Causal: the first key blocks are seen by the most positions; they go first.
  int lin = blockIdx.x;
  const int hk = lin % a.Hkv;
  lin /= a.Hkv;
  const int b = lin % a.B;
  const int j_blk = (lin / a.B) * BLOCK_ROWS;
  int lo[2], hi[2], t_lo, n_t;
  dkdv_walk(a, j_blk, &lo[0], &hi[0]);
  dkdv_walk(a, j_blk + ROWS, &lo[1], &hi[1]);
  block_walk(lo, hi, &t_lo, &n_t);
  const int n_iter = n_t * a.group;  // each q head of the group, one after another
  init_ring<STAGES>(kv_full, 1, full, 32, empty);

  const int c = threadIdx.x / WG;
  const int tid = threadIdx.x % WG, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool loader = threadIdx.x < 32;  // warp 0 also keeps the ring full

  // The loader warp's two halves of filling the stage of walk step `it`:
  // the step's statistics into registers (early, so that their latency
  // hides behind a tile's work), then, once the stage is free, those into
  // shared memory and Q and dO by TMA.
  auto load_stats = [&](int it, float* l, float* d) {
    tile_stats(a, b, hk * a.group + it / n_t, (t_lo + it % n_t) * ROWS, lane, l, d);
  };
  auto fill = [&](int it, const float* l, const float* d) {
    const int stage = it % STAGES, hq = hk * a.group + it / n_t, p0 = (t_lo + it % n_t) * ROWS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s_lse[stage * ROWS + lane + 32 * h] = l[h];
      s_delta[stage * ROWS + lane + 32 * h] = d[h];
    }
    if (lane == 0) {
      bar_arrive_expect(&full[stage], 2 * TL::BYTES);
      for (int cb = 0; cb < TL::BLOCKS; ++cb) {
        const int at = stage * TL::BYTES + cb * TL::BLOCK_BYTES;
        tma_load_4d(smem + SM::Q + at, &maps.q, &full[stage], cb * TL::BOX, hq, p0, b);
        tma_load_4d(smem + SM::DO + at, &maps.dout, &full[stage], cb * TL::BOX, hq, p0, b);
      }
    } else {
      bar_arrive(&full[stage]);
    }
  };
  if (loader) {
    if (lane == 0) {
      bar_arrive_expect(kv_full, 4 * TL::BYTES);
      for (int half = 0; half < 2; ++half)
        for (int cb = 0; cb < TL::BLOCKS; ++cb) {
          const int at = half * TL::BYTES + cb * TL::BLOCK_BYTES, j = j_blk + half * ROWS;
          tma_load_4d(smem + SM::K + at, &maps.k, kv_full, cb * TL::BOX, hk, j, b);
          tma_load_4d(smem + SM::V + at, &maps.v, kv_full, cb * TL::BOX, hk, j, b);
        }
    }
    float l[STAGES][2], d[STAGES][2];  // every stage starts free
#pragma unroll
    for (int it = 0; it < STAGES; ++it)
      if (it < n_iter) load_stats(it, l[it], d[it]);
#pragma unroll
    for (int it = 0; it < STAGES; ++it)
      if (it < n_iter) fill(it, l[it], d[it]);
  }

  // Each warpgroup: 64 keys' dK and dV for the whole walk.
  const int j0 = j_blk + c * ROWS;
  const int my_lo = c ? lo[1] : lo[0], my_hi = c ? hi[1] : hi[0];
  const uint32_t sK = smem_u32(smem + SM::K + c * TL::BYTES);
  const uint32_t sV = smem_u32(smem + SM::V + c * TL::BYTES);
  const float sl2 = a.scale * LOG2E;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  // A tile's dV and dK products are waited for only after the next tile's
  // S^T and dP^T are started, so the tensor cores always have work queued;
  // its stage is released then.  `pa` and `da` hold the pending products'
  // P^T and dS^T until they are done.
  uint32_t pa[4][4], da[4][4];
  int pending = -1;  // the stage whose dV, dK products are in flight
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[stage]);
  };
  bar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int stage = it % STAGES, t = t_lo + it % n_t;
    // the step whose stage the loader refills after this one: it - 1's
    const int refill = it - 1 + STAGES;
    const bool refills = loader && it >= 1 && refill < n_iter;
    float l[2], d[2];
    if (refills) load_stats(refill, l, d);
    bar_wait(&full[stage], (it / STAGES) & 1);
    __syncwarp();  // converged again for the .aligned wgmma instructions
    if (t >= my_lo && t < my_hi) {
      const uint32_t sQ = smem_u32(smem + SM::Q + stage * TL::BYTES);
      const uint32_t sO = smem_u32(smem + SM::DO + stage * TL::BYTES);
      const uint32_t tK = opaque(sK), tV = opaque(sV);
      const float* L = s_lse + stage * ROWS;
      const float* Dl = s_delta + stage * ROWS;
      const int p0 = t * ROWS;
      const bool unmasked = mask_free(a, p0, j0);
      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 positions, unscaled)
      float s[32], dp[32];
      wgmma_fence();
      wgmma_ss64_init(s, desc_k<D>(tK, 0), desc_k<D>(sQ, 0));
#pragma unroll
      for (int ks = 1; ks < D / 16; ++ks) wgmma_ss64(s, desc_k<D>(tK, ks), desc_k<D>(sQ, ks));
      wgmma_commit();
      wgmma_ss64_init(dp, desc_k<D>(tV, 0), desc_k<D>(sO, 0));
#pragma unroll
      for (int ks = 1; ks < D / 16; ++ks) wgmma_ss64(dp, desc_k<D>(tV, ks), desc_k<D>(sO, ks));
      wgmma_commit();
      if (pending >= 0) {  // the previous tile's dV and dK products
        wgmma_wait<2>();
        release(pending);
      }
      softmax_grad(
          s, dp, sl2, [&](int j, int e) { return L[8 * j + 2 * t4 + (e & 1)]; },
          [&](int j, int e) { return Dl[8 * j + 2 * t4 + (e & 1)]; },
          [&](int j, int e) {
            return unmasked || valid(a, j0 + 16 * warp + g + 8 * (e >> 1),
                                     a.q_offset + p0 + 8 * j + 2 * t4 + (e & 1));
          },
          pa, da);
      // dV += P^T dO, dK += dS^T Q
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dv, pa[kk], desc_mn<D>(sO, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dk, da[kk], desc_mn<D>(sQ, kk));
      wgmma_commit();
      pending = stage;
    } else {
      if (pending >= 0) {
        wgmma_wait<0>();
        release(pending);
        pending = -1;
      }
      release(stage);
    }
    if (refills) {  // both warpgroups are done with step it - 1: reuse its stage
      bar_wait(&empty[(it - 1) % STAGES], ((it - 1) / STAGES) & 1);
      fill(refill, l, d);
    }
  }
  wgmma_wait<0>();
  fence_regs<D / 2>(dv);
  fence_regs<D / 2>(dk);
  if (pending >= 0) release(pending);

  // dK / sqrt(D) and dV in bf16, staged in this warpgroup's own K and V tiles
  unsigned char* const tk = smem + SM::K + c * TL::BYTES;
  unsigned char* const tv = smem + SM::V + c * TL::BYTES;
  stage_tile<D>(tk, dk, a.scale, warp, g, t4);
  stage_tile<D>(tv, dv, 1.f, warp, g, t4);
  fence_async_smem();
  warpgroup_sync(1 + c);
  if (tid == 0 && j0 < a.Skv) {
    for (int cb = 0; cb < TL::BLOCKS; ++cb) {
      tma_store_4d(&maps.dk, tk + cb * TL::BLOCK_BYTES, cb * TL::BOX, hk, j0, b);
      tma_store_4d(&maps.dv, tv + cb * TL::BLOCK_BYTES, cb * TL::BOX, hk, j0, b);
    }
    tma_store_wait();
  }
}

// ------------------------------------------------------------------ bf16 dQ --
struct DqMaps {
  CUtensorMap q, dout, k, v, dq;
};

template <int D>
struct DqSmem {  // byte offsets from a 1024-aligned base
  static constexpr int T = Tile<D>::BYTES;
  static constexpr int Q = 0, DO = 2 * T, K = 4 * T, V = K + STAGES * T;
  static constexpr int LSE = V + STAGES * T, DELTA = LSE + BLOCK_ROWS * 4;
  static constexpr int BARS = DELTA + BLOCK_ROWS * 4;  // qo, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BARS + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ DqMaps maps, const Args a, int n_qb) {
  using SM = DqSmem<D>;
  using TL = Tile<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = align_1024(smem_raw);
  float* const s_lse = reinterpret_cast<float*>(smem + SM::LSE);  // [BLOCK_ROWS]
  float* const s_delta = reinterpret_cast<float*>(smem + SM::DELTA);
  uint64_t* const qo_full = reinterpret_cast<uint64_t*>(smem + SM::BARS);
  uint64_t* const full = qo_full + 1;
  uint64_t* const empty = full + STAGES;

  // Heaviest causal position blocks first, as in the forward.
  int lin = blockIdx.x;
  const int hq = lin % a.H;
  lin /= a.H;
  const int b = lin % a.B;
  const int p_blk = (n_qb - 1 - lin / a.B) * BLOCK_ROWS;
  const int hk = hq / a.group;
  int lo[2], hi[2], t_lo, n_t;
  dq_walk(a, p_blk, &lo[0], &hi[0]);
  dq_walk(a, p_blk + ROWS, &lo[1], &hi[1]);
  block_walk(lo, hi, &t_lo, &n_t);
  init_ring<STAGES>(qo_full, 32, full, 1, empty);

  const int c = threadIdx.x / WG;
  const int tid = threadIdx.x % WG, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // Thread 0 also keeps the ring of K/V tiles full.
  auto fill = [&](int it) {
    const int stage = it % STAGES, k0 = (t_lo + it) * ROWS;
    bar_arrive_expect(&full[stage], 2 * TL::BYTES);
    for (int cb = 0; cb < TL::BLOCKS; ++cb) {
      const int at = stage * TL::BYTES + cb * TL::BLOCK_BYTES;
      tma_load_4d(smem + SM::K + at, &maps.k, &full[stage], cb * TL::BOX, hk, k0, b);
      tma_load_4d(smem + SM::V + at, &maps.v, &full[stage], cb * TL::BOX, hk, k0, b);
    }
  };
  if (threadIdx.x < 32) {  // the block's positions' statistics, Q and dO
    float l[BLOCK_ROWS / 32], d[BLOCK_ROWS / 32];
#pragma unroll
    for (int half = 0; half < 2; ++half)
      tile_stats(a, b, hq, p_blk + half * ROWS, lane, l + 2 * half, d + 2 * half);
#pragma unroll
    for (int h = 0; h < BLOCK_ROWS / 32; ++h) {
      s_lse[lane + 32 * h] = l[h];
      s_delta[lane + 32 * h] = d[h];
    }
    if (lane == 0) {
      bar_arrive_expect(qo_full, 4 * TL::BYTES);
      for (int half = 0; half < 2; ++half)
        for (int cb = 0; cb < TL::BLOCKS; ++cb) {
          const int at = half * TL::BYTES + cb * TL::BLOCK_BYTES, p = p_blk + half * ROWS;
          tma_load_4d(smem + SM::Q + at, &maps.q, qo_full, cb * TL::BOX, hq, p, b);
          tma_load_4d(smem + SM::DO + at, &maps.dout, qo_full, cb * TL::BOX, hq, p, b);
        }
      for (int it = 0; it < min(STAGES, n_t); ++it) fill(it);  // every stage starts free
    } else {
      bar_arrive(qo_full);
    }
  }

  // Each warpgroup: 64 positions' dQ for the whole walk.
  const int p0 = p_blk + c * ROWS;
  const int my_lo = c ? lo[1] : lo[0], my_hi = c ? hi[1] : hi[0];
  const uint32_t sQ = smem_u32(smem + SM::Q + c * TL::BYTES);
  const uint32_t sO = smem_u32(smem + SM::DO + c * TL::BYTES);
  const float sl2 = a.scale * LOG2E;
  bar_wait(qo_full, 0);
  float lse_row[2], delta_row[2];
  int pos_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
    lse_row[h] = s_lse[c * ROWS + r];
    delta_row[h] = s_delta[c * ROWS + r];
    pos_row[h] = a.q_offset + p0 + r;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  // A tile's dQ product is waited for only after the next tile's S and dP
  // are started, so the tensor cores always have work queued; its stage is
  // released then.  `da` holds the pending product's dS until it is done.
  uint32_t da[4][4];
  int pending = -1;  // the stage whose dQ product is in flight
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[stage]);
  };
  for (int it = 0; it < n_t; ++it) {
    const int stage = it % STAGES, t = t_lo + it;
    bar_wait(&full[stage], (it / STAGES) & 1);
    __syncwarp();  // converged again for the .aligned wgmma instructions
    if (t >= my_lo && t < my_hi) {
      const uint32_t sK = smem_u32(smem + SM::K + stage * TL::BYTES);
      const uint32_t sV = smem_u32(smem + SM::V + stage * TL::BYTES);
      const uint32_t tQ = opaque(sQ), tO = opaque(sO);
      const int k0 = t * ROWS;
      const bool unmasked = mask_free(a, p0, k0);
      // S = Q K^T and dP = dO V^T (64 positions x 64 keys, unscaled)
      float s[32], dp[32];
      wgmma_fence();
      wgmma_ss64_init(s, desc_k<D>(tQ, 0), desc_k<D>(sK, 0));
#pragma unroll
      for (int ks = 1; ks < D / 16; ++ks) wgmma_ss64(s, desc_k<D>(tQ, ks), desc_k<D>(sK, ks));
      wgmma_commit();
      wgmma_ss64_init(dp, desc_k<D>(tO, 0), desc_k<D>(sV, 0));
#pragma unroll
      for (int ks = 1; ks < D / 16; ++ks) wgmma_ss64(dp, desc_k<D>(tO, ks), desc_k<D>(sV, ks));
      wgmma_commit();
      if (pending >= 0) {  // the previous tile's dQ product
        wgmma_wait<2>();
        release(pending);
      }
      uint32_t pa[4][4];
      softmax_grad(
          s, dp, sl2, [&](int, int e) { return lse_row[e >> 1]; },
          [&](int, int e) { return delta_row[e >> 1]; },
          [&](int j, int e) {
            return unmasked || valid(a, k0 + 8 * j + 2 * t4 + (e & 1), pos_row[e >> 1]);
          },
          pa, da);
      // dQ += dS K
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dq, da[kk], desc_mn<D>(sK, kk));
      wgmma_commit();
      pending = stage;
    } else {
      if (pending >= 0) {
        wgmma_wait<0>();
        release(pending);
        pending = -1;
      }
      release(stage);
    }
    // thread 0 refills the stage of step it - 1 once both warpgroups are done
    if (threadIdx.x == 0 && it >= 1 && it - 1 + STAGES < n_t) {
      bar_wait(&empty[(it - 1) % STAGES], ((it - 1) / STAGES) & 1);
      fill(it - 1 + STAGES);
    }
  }
  wgmma_wait<0>();
  fence_regs<D / 2>(dq);
  if (pending >= 0) release(pending);

  // dQ / sqrt(D) in bf16, staged in this warpgroup's own Q tile
  unsigned char* const tq = smem + SM::Q + c * TL::BYTES;
  stage_tile<D>(tq, dq, a.scale, warp, g, t4);
  fence_async_smem();
  warpgroup_sync(1 + c);
  if (tid == 0 && p0 < a.Sq) {
    for (int cb = 0; cb < TL::BLOCKS; ++cb)
      tma_store_4d(&maps.dq, tq + cb * TL::BLOCK_BYTES, cb * TL::BOX, hq, p0, b);
    tma_store_wait();
  }
}

// ------------------------------------------------ bf16 at head dim 256 --
// The kernels the header describes for D = 256 (gemma3): a block of two
// warpgroups owns one tile of ROWS keys (dK/dV) or positions (dQ);
// warpgroup 0 computes S and P, warpgroup 1 dP, and each accumulates its
// half of D of the products that follow.
constexpr int WIDE = 256;
constexpr int WIDE_STAGES = 2;                       // the ring of walked tiles
constexpr int HALF_BLOCKS = Tile<WIDE>::BLOCKS / 2;  // column blocks of a half of D
constexpr int BAR_DP = 3, BAR_PDS = 4;  // dP written; P and dS written

// One walked tile of the D = 256 kernels: warpgroup 0's S (S^T for dK/dV)
// or warpgroup 1's dP (dP^T), 64 x 64 f32, unscaled; A and B are K-major
// tiles of 256 columns.
__device__ __forceinline__ void wide_scores(float* acc, uint32_t tA, uint32_t tB) {
  wgmma_fence();
  wgmma_ss64_init(acc, desc_k<WIDE>(tA, 0), desc_k<WIDE>(tB, 0));
#pragma unroll
  for (int ks = 1; ks < WIDE / 16; ++ks)
    wgmma_ss64(acc, desc_k<WIDE>(tA, ks), desc_k<WIDE>(tB, ks));
  wgmma_commit();
}

// Warpgroup 1 hands dP over, each thread its fragment's 32 values at a
// stride of WG (no bank conflicts), and warpgroup 0 reads them back in
// the same fragment order.
__device__ __forceinline__ void put_dp(float* x_dp, const float* dp, int tid) {
#pragma unroll
  for (int i = 0; i < 32; ++i) x_dp[i * WG + tid] = dp[i];
}

struct WideDkvSmem {  // byte offsets from a 1024-aligned base
  static constexpr int T = Tile<WIDE>::BYTES, X = Tile<ROWS>::BYTES;
  static constexpr int K = 0, V = T, Q = 2 * T, DO = Q + WIDE_STAGES * T;
  static constexpr int P = DO + WIDE_STAGES * T, DS = P + X, DP = DS + X;  // DP: 64 x 64 f32
  static constexpr int LSE = DP + ROWS * ROWS * 4, DELTA = LSE + WIDE_STAGES * ROWS * 4;
  static constexpr int BARS = DELTA + WIDE_STAGES * ROWS * 4;  // kv, full[], empty[]
  static constexpr int BYTES = BARS + (1 + 2 * WIDE_STAGES) * 8 + 1024;
};
static_assert(WideDkvSmem::BYTES <= 232448, "dK/dV at D = 256 exceeds a block's shared memory");

__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_bwd_dkdv_wide_kernel(const __grid_constant__ DkvMaps maps, const Args a) {
  constexpr int D = WIDE;
  using SM = WideDkvSmem;
  using TL = Tile<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = align_1024(smem_raw);
  float* const s_lse = reinterpret_cast<float*>(smem + SM::LSE);  // [WIDE_STAGES][ROWS]
  float* const s_delta = reinterpret_cast<float*>(smem + SM::DELTA);
  float* const x_dp = reinterpret_cast<float*>(smem + SM::DP);
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(smem + SM::BARS);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + WIDE_STAGES;

  // Causal: the first key tiles are seen by the most positions; they go first.
  int lin = blockIdx.x;
  const int hk = lin % a.Hkv;
  lin /= a.Hkv;
  const int b = lin % a.B;
  const int j0 = (lin / a.B) * ROWS;
  int t_lo, t_hi;
  dkdv_walk(a, j0, &t_lo, &t_hi);
  const int n_t = t_hi - t_lo;
  const int n_iter = n_t * a.group;  // each q head of the group, one after another
  init_ring<WIDE_STAGES>(kv_full, 1, full, 32, empty);

  const int c = threadIdx.x / WG;
  const int tid = threadIdx.x % WG, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool loader = c == 1 && warp == 0;  // also keeps the ring full

  // As in flash_bwd_dkdv_kernel: a step's statistics into registers early,
  // then, once its stage is free, into shared memory, and Q and dO by TMA.
  auto load_stats = [&](int it, float* l, float* d) {
    tile_stats(a, b, hk * a.group + it / n_t, (t_lo + it % n_t) * ROWS, lane, l, d);
  };
  auto fill = [&](int it, const float* l, const float* d) {
    const int stage = it % WIDE_STAGES, hq = hk * a.group + it / n_t;
    const int p0 = (t_lo + it % n_t) * ROWS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s_lse[stage * ROWS + lane + 32 * h] = l[h];
      s_delta[stage * ROWS + lane + 32 * h] = d[h];
    }
    if (lane == 0) {
      bar_arrive_expect(&full[stage], 2 * TL::BYTES);
      for (int cb = 0; cb < TL::BLOCKS; ++cb) {
        const int at = stage * TL::BYTES + cb * TL::BLOCK_BYTES;
        tma_load_4d(smem + SM::Q + at, &maps.q, &full[stage], cb * TL::BOX, hq, p0, b);
        tma_load_4d(smem + SM::DO + at, &maps.dout, &full[stage], cb * TL::BOX, hq, p0, b);
      }
    } else {
      bar_arrive(&full[stage]);
    }
  };
  if (loader) {
    if (lane == 0) {
      bar_arrive_expect(kv_full, 2 * TL::BYTES);
      for (int cb = 0; cb < TL::BLOCKS; ++cb) {
        const int at = cb * TL::BLOCK_BYTES;
        tma_load_4d(smem + SM::K + at, &maps.k, kv_full, cb * TL::BOX, hk, j0, b);
        tma_load_4d(smem + SM::V + at, &maps.v, kv_full, cb * TL::BOX, hk, j0, b);
      }
    }
    float l[WIDE_STAGES][2], d[WIDE_STAGES][2];  // every stage starts free
#pragma unroll
    for (int it = 0; it < WIDE_STAGES; ++it)
      if (it < n_iter) load_stats(it, l[it], d[it]);
#pragma unroll
    for (int it = 0; it < WIDE_STAGES; ++it)
      if (it < n_iter) fill(it, l[it], d[it]);
  }

  const uint32_t sK = smem_u32(smem + SM::K), sV = smem_u32(smem + SM::V);
  const uint32_t xP = smem_u32(smem + SM::P), xDS = smem_u32(smem + SM::DS);
  const int half = c * HALF_BLOCKS * TL::BLOCK_BYTES;  // this warpgroup's columns of a tile
  const float sl2 = a.scale * LOG2E;
  // 64 keys x this warpgroup's 128 columns, set by the first step's first
  // products: zeroing them by other instructions serializes the wgmma
  float dk[D / 4], dv[D / 4];
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[stage]);
  };
  bar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int stage = it % WIDE_STAGES, p0 = (t_lo + it % n_t) * ROWS;
    const uint32_t sQ = smem_u32(smem + SM::Q + stage * TL::BYTES);
    const uint32_t sO = smem_u32(smem + SM::DO + stage * TL::BYTES);
    bar_wait(&full[stage], (it / WIDE_STAGES) & 1);
    __syncwarp();  // converged again for the .aligned wgmma instructions
    float acc[32];  // S^T (warpgroup 0) or dP^T (warpgroup 1): 64 keys x 64 positions
    wide_scores(acc, opaque(c ? sV : sK), c ? sO : sQ);
    wgmma_wait<0>();  // and this warpgroup's products of the step before
    fence_regs<32>(acc);
    if (it > 0) release((it - 1) % WIDE_STAGES);
    if (c == 1) {
      put_dp(x_dp, acc, tid);
      block_arrive(BAR_DP);
      // refill the stage of step it - 1, which both warpgroups have released
      // once warpgroup 0 is past its S^T, with step it + 1
      if (loader && it >= 1 && it + 1 < n_iter) {
        float l[2], d[2];
        load_stats(it + 1, l, d);
        bar_wait(&empty[(it - 1) % WIDE_STAGES], ((it - 1) / WIDE_STAGES) & 1);
        fill(it + 1, l, d);
      }
      __syncwarp();
    } else {
      const float* L = s_lse + stage * ROWS;
      const float* Dl = s_delta + stage * ROWS;
      const bool unmasked = mask_free(a, p0, j0);
      // P^T = exp2(S^T log2(e) / sqrt(D) - lse); element e of block j is key
      // 16 warp + g + 8 (e / 2), position 8 j + 2 t4 + e % 2
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t4 + (e & 1);
          const float p = exp2f(fmaf(acc[4 * j + e], sl2, -L[col]));
          acc[4 * j + e] = unmasked || valid(a, j0 + 16 * warp + g + 8 * (e >> 1),
                                             a.q_offset + p0 + col)
                               ? p
                               : 0.f;
        }
      // dP^T is in x_dp, and warpgroup 1's products of the step before,
      // which read the P^T and dS^T tiles, are done
      block_sync(BAR_DP);
      stage_tile<ROWS>(smem + SM::P, acc, 1.f, warp, g, t4);
      // dS^T = P^T (dP^T - Delta)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * j + e] *= x_dp[(4 * j + e) * WG + tid] - Dl[8 * j + 2 * t4 + (e & 1)];
      stage_tile<ROWS>(smem + SM::DS, acc, 1.f, warp, g, t4);
      fence_async_smem();
    }
    block_sync(BAR_PDS);  // P^T and dS^T are in their tiles
    // this warpgroup's half of D: dV += P^T dO, dK += dS^T Q
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss128_mn(dv, desc_k<ROWS>(xP, kk), desc_mn<D>(sO + half, kk), it > 0 || kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss128_mn(dk, desc_k<ROWS>(xDS, kk), desc_mn<D>(sQ + half, kk), it > 0 || kk > 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs<D / 4>(dv);
  fence_regs<D / 4>(dk);

  // dK / sqrt(D) and dV in bf16 (zeros where no position sees a key),
  // staged in this warpgroup's half of the K and V tiles (both warpgroups'
  // S^T and dP^T were done before the last BAR_PDS)
  unsigned char* const tk = smem + SM::K;
  unsigned char* const tv = smem + SM::V;
  stage_tile<D, D / 2>(tk, dk, a.scale, warp, g, t4, c * D / 2, n_iter == 0);
  stage_tile<D, D / 2>(tv, dv, 1.f, warp, g, t4, c * D / 2, n_iter == 0);
  fence_async_smem();
  warpgroup_sync(1 + c);
  if (tid == 0 && j0 < a.Skv) {
    for (int cb = c * HALF_BLOCKS; cb < (c + 1) * HALF_BLOCKS; ++cb) {
      tma_store_4d(&maps.dk, tk + cb * TL::BLOCK_BYTES, cb * TL::BOX, hk, j0, b);
      tma_store_4d(&maps.dv, tv + cb * TL::BLOCK_BYTES, cb * TL::BOX, hk, j0, b);
    }
    tma_store_wait();
  }
}

struct WideDqSmem {  // byte offsets from a 1024-aligned base
  static constexpr int T = Tile<WIDE>::BYTES, X = Tile<ROWS>::BYTES;
  static constexpr int Q = 0, DO = T, K = 2 * T, V = K + WIDE_STAGES * T;
  static constexpr int DS = V + WIDE_STAGES * T, DP = DS + X;  // DP: 64 x 64 f32
  static constexpr int LSE = DP + ROWS * ROWS * 4, DELTA = LSE + ROWS * 4;
  static constexpr int BARS = DELTA + ROWS * 4;  // qo, full[], empty[]
  static constexpr int BYTES = BARS + (1 + 2 * WIDE_STAGES) * 8 + 1024;
};
static_assert(WideDqSmem::BYTES <= 232448, "dQ at D = 256 exceeds a block's shared memory");

__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_bwd_dq_wide_kernel(const __grid_constant__ DqMaps maps, const Args a, int n_qb) {
  constexpr int D = WIDE;
  using SM = WideDqSmem;
  using TL = Tile<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = align_1024(smem_raw);
  float* const s_lse = reinterpret_cast<float*>(smem + SM::LSE);  // [ROWS]
  float* const s_delta = reinterpret_cast<float*>(smem + SM::DELTA);
  float* const x_dp = reinterpret_cast<float*>(smem + SM::DP);
  uint64_t* const qo_full = reinterpret_cast<uint64_t*>(smem + SM::BARS);
  uint64_t* const full = qo_full + 1;
  uint64_t* const empty = full + WIDE_STAGES;

  // Heaviest causal position tiles first, as in the forward.
  int lin = blockIdx.x;
  const int hq = lin % a.H;
  lin /= a.H;
  const int b = lin % a.B;
  const int p0 = (n_qb - 1 - lin / a.B) * ROWS;
  const int hk = hq / a.group;
  int t_lo, t_hi;
  dq_walk(a, p0, &t_lo, &t_hi);
  const int n_t = t_hi - t_lo;
  init_ring<WIDE_STAGES>(qo_full, 32, full, 1, empty);

  const int c = threadIdx.x / WG;
  const int tid = threadIdx.x % WG, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // Warp 0 of warpgroup 1 loads the tile's statistics, Q and dO; its
  // thread 0 also keeps the ring of K/V tiles full.
  auto fill = [&](int it) {
    const int stage = it % WIDE_STAGES, k0 = (t_lo + it) * ROWS;
    bar_arrive_expect(&full[stage], 2 * TL::BYTES);
    for (int cb = 0; cb < TL::BLOCKS; ++cb) {
      const int at = stage * TL::BYTES + cb * TL::BLOCK_BYTES;
      tma_load_4d(smem + SM::K + at, &maps.k, &full[stage], cb * TL::BOX, hk, k0, b);
      tma_load_4d(smem + SM::V + at, &maps.v, &full[stage], cb * TL::BOX, hk, k0, b);
    }
  };
  if (c == 1 && warp == 0) {
    float l[2], d[2];
    tile_stats(a, b, hq, p0, lane, l, d);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s_lse[lane + 32 * h] = l[h];
      s_delta[lane + 32 * h] = d[h];
    }
    if (lane == 0) {
      bar_arrive_expect(qo_full, 2 * TL::BYTES);
      for (int cb = 0; cb < TL::BLOCKS; ++cb) {
        const int at = cb * TL::BLOCK_BYTES;
        tma_load_4d(smem + SM::Q + at, &maps.q, qo_full, cb * TL::BOX, hq, p0, b);
        tma_load_4d(smem + SM::DO + at, &maps.dout, qo_full, cb * TL::BOX, hq, p0, b);
      }
      for (int it = 0; it < min(WIDE_STAGES, n_t); ++it) fill(it);  // every stage starts free
    } else {
      bar_arrive(qo_full);
    }
  }

  const uint32_t sQ = smem_u32(smem + SM::Q), sO = smem_u32(smem + SM::DO);
  const uint32_t xDS = smem_u32(smem + SM::DS);
  const int half = c * HALF_BLOCKS * TL::BLOCK_BYTES;  // this warpgroup's columns of a tile
  const float sl2 = a.scale * LOG2E;
  bar_wait(qo_full, 0);
  float lse_row[2], delta_row[2];
  int pos_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
    lse_row[h] = s_lse[r];
    delta_row[h] = s_delta[r];
    pos_row[h] = a.q_offset + p0 + r;
  }
  // 64 positions x this warpgroup's 128 columns, set by the first step's
  // first product (as dK and dV above)
  float dq[D / 4];
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[stage]);
  };
  for (int it = 0; it < n_t; ++it) {
    const int stage = it % WIDE_STAGES, k0 = (t_lo + it) * ROWS;
    const uint32_t sK = smem_u32(smem + SM::K + stage * TL::BYTES);
    const uint32_t sV = smem_u32(smem + SM::V + stage * TL::BYTES);
    bar_wait(&full[stage], (it / WIDE_STAGES) & 1);
    __syncwarp();  // converged again for the .aligned wgmma instructions
    float acc[32];  // S (warpgroup 0) or dP (warpgroup 1): 64 positions x 64 keys
    wide_scores(acc, opaque(c ? sO : sQ), c ? sV : sK);
    wgmma_wait<0>();  // and this warpgroup's product of the step before
    fence_regs<32>(acc);
    if (it > 0) release((it - 1) % WIDE_STAGES);
    if (c == 1) {
      put_dp(x_dp, acc, tid);
      block_arrive(BAR_DP);
      // refill the stage of step it - 1 with step it + 1
      if (threadIdx.x == WG && it >= 1 && it + 1 < n_t) {
        bar_wait(&empty[(it - 1) % WIDE_STAGES], ((it - 1) / WIDE_STAGES) & 1);
        fill(it + 1);
      }
      __syncwarp();
    } else {
      const bool unmasked = mask_free(a, p0, k0);
      // P = exp2(S log2(e) / sqrt(D) - lse); element e of block j is
      // position 16 warp + g + 8 (e / 2), key 8 j + 2 t4 + e % 2
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(acc[4 * j + e], sl2, -lse_row[e >> 1]));
          acc[4 * j + e] =
              unmasked || valid(a, k0 + 8 * j + 2 * t4 + (e & 1), pos_row[e >> 1]) ? p : 0.f;
        }
      // dP is in x_dp, and warpgroup 1's product of the step before,
      // which read the dS tile, is done
      block_sync(BAR_DP);
      // dS = P (dP - Delta)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= x_dp[i * WG + tid] - delta_row[(i & 3) >> 1];
      stage_tile<ROWS>(smem + SM::DS, acc, 1.f, warp, g, t4);
      fence_async_smem();
    }
    block_sync(BAR_PDS);  // dS is in its tile
    // this warpgroup's half of D: dQ += dS K (K through the transpose bit)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss128_mn(dq, desc_k<ROWS>(xDS, kk), desc_mn<D>(sK + half, kk), it > 0 || kk > 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs<D / 4>(dq);

  // dQ / sqrt(D) in bf16 (zeros where a position sees no key), staged in
  // this warpgroup's half of the Q tile (warpgroup 0's S were done before
  // the last BAR_PDS)
  unsigned char* const tq = smem + SM::Q;
  stage_tile<D, D / 2>(tq, dq, a.scale, warp, g, t4, c * D / 2, n_t == 0);
  fence_async_smem();
  warpgroup_sync(1 + c);
  if (tid == 0 && p0 < a.Sq) {
    for (int cb = c * HALF_BLOCKS; cb < (c + 1) * HALF_BLOCKS; ++cb)
      tma_store_4d(&maps.dq, tq + cb * TL::BLOCK_BYTES, cb * TL::BOX, hq, p0, b);
    tma_store_wait();
  }
}

// --------------------------------------------------------- FMA dK, dV, dQ --
// Plain loads (converted to f32) into shared-memory tiles with a pitch of
// D + 1 floats, so a warp reading one column of 32 rows hits 32 banks.
template <typename T, int D, typename RowPtr>
__device__ __forceinline__ void load_tile(float* dst, int rows, int nrows, RowPtr row_ptr,
                                          int tid) {
  for (int i = tid; i < rows * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r < nrows ? to_f(row_ptr(r)[c]) : 0.f;
  }
}

template <int D>
struct FmaDkvSmem {
  static constexpr int BM = fma_rows<D>();
  static constexpr int LT = D + 1, LP = BQ + 1;
  static constexpr int K = 0, V = K + BM * LT, DK = V + BM * LT, DV = DK + BM * LT;
  static constexpr int Q = DV + BM * LT, DO = Q + BQ * LT;
  static constexpr int P = DO + BQ * LT, DS = P + BM * LP;
  static constexpr int L = DS + BM * LP, DELTA = L + BQ;
  static constexpr int BYTES = (DELTA + BQ) * 4;
};
static_assert(FmaDkvSmem<256>::BYTES <= 232448, "f32 dK/dV at D = 256: shared memory");

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_fma_kernel(Args a) {
  using SM = FmaDkvSmem<D>;
  constexpr int LT = SM::LT, LP = SM::LP, BM = SM::BM;
  constexpr int RPT = BQ * BM / NT;  // a thread's query rows of a tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* const sm = reinterpret_cast<float*>(smem_raw);
  float *sK = sm + SM::K, *sV = sm + SM::V, *sdK = sm + SM::DK, *sdV = sm + SM::DV;
  float *sQ = sm + SM::Q, *sO = sm + SM::DO, *sP = sm + SM::P, *sS = sm + SM::DS;
  float *sL = sm + SM::L, *sD = sm + SM::DELTA;

  int lin = blockIdx.x;
  const int hk = lin % a.Hkv;
  lin /= a.Hkv;
  const int b = lin % a.B;
  const int j0 = (lin / a.B) * BM;
  const int nk = min(BM, a.Skv - j0);
  const int tid = threadIdx.x, group = a.group;
  int r_lo, r_hi;
  rows_seeing(a, j0, nk, &r_lo, &r_hi);

  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + hk * a.sv.h;
  load_tile<T, D>(sK, BM, nk, [&](int r) { return kb + (long long)(j0 + r) * a.sk.s; }, tid);
  load_tile<T, D>(sV, BM, nk, [&](int r) { return vb + (long long)(j0 + r) * a.sv.s; }, tid);
  for (int i = tid; i < BM * LT; i += NT) sdK[i] = sdV[i] = 0.f;

  // Scores: a thread holds key c = tid % BM against RPT of the tile's rows.
  const int c = tid % BM, rb = (tid / BM) * RPT;
  for (int r0 = r_lo; r0 < r_hi; r0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    const int n = min(BQ, r_hi - r0);
    load_tile<T, D>(sQ, BQ, n, [&](int r) { return row_ptr<T>(a.q, a.sq, b, hk, group, r0 + r); },
                    tid);
    load_tile<T, D>(sO, BQ, n,
                    [&](int r) { return row_ptr<T>(a.dout, a.sdo, b, hk, group, r0 + r); }, tid);
    for (int r = tid; r < BQ; r += NT) {
      sL[r] = tile_lse(a, b, hk, r0 + r, r_hi);
      sD[r] = r0 + r < r_hi ? a.delta[stat_index(a, b, hk, r0 + r)] : 0.f;
    }
    __syncthreads();
    float s[RPT], dp[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) s[i] = dp[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = sK[c * LT + d], vd = sV[c * LT + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        s[i] = fmaf(kd, sQ[(rb + i) * LT + d], s[i]);
        dp[i] = fmaf(vd, sO[(rb + i) * LT + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rb + i;
      float p = exp2f(s[i] * a.scale * LOG2E - sL[r]);
      if (!valid(a, j0 + c, a.q_offset + (r0 + r) / group)) p = 0.f;
      sP[c * LP + r] = p;
      sS[c * LP + r] = p * (dp[i] - sD[r]);
    }
    __syncthreads();
    // dV[c][d] += sum_r P[c][r] dO[r][d], dK likewise from dS and Q.
    for (int d = tid / BM; d < D; d += NT / BM) {
      float av = sdV[c * LT + d], ak = sdK[c * LT + d];
      for (int r = 0; r < BQ; ++r) {
        av = fmaf(sP[c * LP + r], sO[r * LT + d], av);
        ak = fmaf(sS[c * LP + r], sQ[r * LT + d], ak);
      }
      sdV[c * LT + d] = av;
      sdK[c * LT + d] = ak;
    }
  }
  __syncthreads();
  T* dkb = static_cast<T*>(a.dk) + b * a.sdk.b + hk * a.sdk.h;
  T* dvb = static_cast<T*>(a.dv) + b * a.sdv.b + hk * a.sdv.h;
  for (int i = tid; i < nk * D; i += NT) {
    const int r = i / D, d = i % D;
    dkb[(long long)(j0 + r) * a.sdk.s + d] = from_f<T>(sdK[r * LT + d] * a.scale);
    dvb[(long long)(j0 + r) * a.sdv.s + d] = from_f<T>(sdV[r * LT + d]);
  }
}

template <int D>
struct FmaDqSmem {
  static constexpr int BM = fma_rows<D>(), BN = fma_rows<D>();
  static constexpr int LT = D + 1, LP = BN + 1;
  static constexpr int Q = 0, DO = Q + BM * LT, DQ = DO + BM * LT;
  static constexpr int K = DQ + BM * LT, V = K + BN * LT, DS = V + BN * LT;
  static constexpr int BYTES = (DS + BM * LP) * 4;
};
static_assert(FmaDqSmem<256>::BYTES <= 232448, "f32 dQ at D = 256: shared memory");

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_fma_kernel(Args a) {
  using SM = FmaDqSmem<D>;
  constexpr int LT = SM::LT, LP = SM::LP, BM = SM::BM, BN = SM::BN;
  constexpr int RPT = BM * BN / NT;  // a thread's rows of the block
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* const sm = reinterpret_cast<float*>(smem_raw);
  float *sQ = sm + SM::Q, *sO = sm + SM::DO, *sdQ = sm + SM::DQ;
  float *sK = sm + SM::K, *sV = sm + SM::V, *sS = sm + SM::DS;

  const int tid = threadIdx.x, group = a.group;
  const int positions = BM / group;
  const int p0 = blockIdx.x * positions;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int nq = min(positions, a.Sq - p0);
  const int r0 = p0 * group, nrows = nq * group;
  int kv_begin, kv_end;
  keys_seen<BN>(a, p0, nq, &kv_begin, &kv_end);

  load_tile<T, D>(sQ, BM, nrows,
                  [&](int r) { return row_ptr<T>(a.q, a.sq, b, hk, group, r0 + r); }, tid);
  load_tile<T, D>(sO, BM, nrows,
                  [&](int r) { return row_ptr<T>(a.dout, a.sdo, b, hk, group, r0 + r); }, tid);
  for (int i = tid; i < BM * LT; i += NT) sdQ[i] = 0.f;

  // Scores: a thread holds key c = tid % BN against RPT of the block's rows.
  const int c = tid % BN, rb = (tid / BN) * RPT;
  float lse[RPT], delta[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rb + i;
    lse[i] = tile_lse(a, b, hk, r0 + r, r0 + nrows);
    delta[i] = r < nrows ? a.delta[stat_index(a, b, hk, r0 + r)] : 0.f;
  }
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + hk * a.sv.h;
  for (int j0 = kv_begin; j0 < kv_end; j0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    const int nk = min(BN, kv_end - j0);
    load_tile<T, D>(sK, BN, nk, [&](int r) { return kb + (long long)(j0 + r) * a.sk.s; }, tid);
    load_tile<T, D>(sV, BN, nk, [&](int r) { return vb + (long long)(j0 + r) * a.sv.s; }, tid);
    __syncthreads();
    float s[RPT], dp[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) s[i] = dp[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = sK[c * LT + d], vd = sV[c * LT + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        s[i] = fmaf(sQ[(rb + i) * LT + d], kd, s[i]);
        dp[i] = fmaf(sO[(rb + i) * LT + d], vd, dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rb + i;
      float p = exp2f(s[i] * a.scale * LOG2E - lse[i]);
      if (!valid(a, j0 + c, a.q_offset + (r0 + r) / group)) p = 0.f;
      sS[r * LP + c] = p * (dp[i] - delta[i]);
    }
    __syncthreads();
    // dQ[r][d] += sum_c dS[r][c] K[c][d]
    for (int i = tid; i < BM * D; i += NT) {
      const int r = i % BM, d = i / BM;
      float acc = sdQ[r * LT + d];
      for (int cc = 0; cc < BN; ++cc) acc = fmaf(sS[r * LP + cc], sK[cc * LT + d], acc);
      sdQ[r * LT + d] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < nrows * D; i += NT) {
    const int r = i / D, d = i % D;
    static_cast<T*>(a.dq)[b * a.sdq.b + (long long)((r0 + r) / group) * a.sdq.s +
                          (long long)(hk * group + (r0 + r) % group) * a.sdq.h + d] =
        from_f<T>(sdQ[r * LT + d] * a.scale);
  }
}

// ----------------------------------------------------------------- launchers --
// The tensor map of a (B, S, heads, D) bf16 tensor, as the 4-D array
// (D, heads, S, B) with its own strides, in boxes of one column block of
// ROWS positions of one head, swizzled as Tile<D> lays them out.  TMA needs
// a 16-byte aligned base and 16-byte strides (the wrapper checks both).
template <int D>
int tensor_map(CUtensorMap* map, const void* base, const Stride& st, int B, int S, int heads) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -3;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {Tile<D>::BOX, 1, ROWS, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = Tile<D>::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : Tile<D>::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                         : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of range: zeros
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <int D>
int launch_preprocess(int dtype, const Args& a, cudaStream_t s) {
  const long long rows = (long long)a.B * a.Sq * a.H;
  const int blocks = (int)((rows * 32 + NT - 1) / NT);
  if (dtype == 1)
    flash_bwd_preprocess_kernel<bf16, D><<<blocks, NT, 0, s>>>(a);
  else
    flash_bwd_preprocess_kernel<float, D><<<blocks, NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// n_blocks: the bf16 grid's blocks per (b, kv head), of BLOCK_ROWS keys (ROWS
// at D = 256).
template <int D>
int launch_dkdv(int dtype, const Args& a, int n_blocks, cudaStream_t s) {
  static unsigned long long done_bf16 = 0, done_f32 = 0;
  if (dtype == 1) {
    DkvMaps m;
    int err = tensor_map<D>(&m.q, a.q, a.sq, a.B, a.Sq, a.H);
    if (!err) err = tensor_map<D>(&m.dout, a.dout, a.sdo, a.B, a.Sq, a.H);
    if (!err) err = tensor_map<D>(&m.k, a.k, a.sk, a.B, a.Skv, a.Hkv);
    if (!err) err = tensor_map<D>(&m.v, a.v, a.sv, a.B, a.Skv, a.Hkv);
    if (!err) err = tensor_map<D>(&m.dk, a.dk, a.sdk, a.B, a.Skv, a.Hkv);
    if (!err) err = tensor_map<D>(&m.dv, a.dv, a.sdv, a.B, a.Skv, a.Hkv);
    if constexpr (D == WIDE) {
      if (!err) err = allow_smem(flash_bwd_dkdv_wide_kernel, WideDkvSmem::BYTES, &done_bf16);
      if (err) return err;
      flash_bwd_dkdv_wide_kernel<<<n_blocks * a.Hkv * a.B, TC_THREADS, WideDkvSmem::BYTES, s>>>(
          m, a);
    } else {
      if (!err) err = allow_smem(flash_bwd_dkdv_kernel<D>, DkvSmem<D>::BYTES, &done_bf16);
      if (err) return err;
      flash_bwd_dkdv_kernel<D>
          <<<n_blocks * a.Hkv * a.B, TC_THREADS, DkvSmem<D>::BYTES, s>>>(m, a);
    }
  } else {
    constexpr int BM = fma_rows<D>();
    const int blocks = (a.Skv + BM - 1) / BM * a.Hkv * a.B;
    int err = allow_smem(flash_bwd_dkdv_fma_kernel<float, D>, FmaDkvSmem<D>::BYTES, &done_f32);
    if (err) return err;
    flash_bwd_dkdv_fma_kernel<float, D><<<blocks, NT, FmaDkvSmem<D>::BYTES, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// n_blocks: the bf16 grid's blocks per (b, q head), of BLOCK_ROWS positions
// (ROWS at D = 256).
template <int D>
int launch_dq(int dtype, const Args& a, int n_blocks, cudaStream_t s) {
  static unsigned long long done_bf16 = 0, done_f32 = 0;
  if (dtype == 1) {
    DqMaps m;
    int err = tensor_map<D>(&m.q, a.q, a.sq, a.B, a.Sq, a.H);
    if (!err) err = tensor_map<D>(&m.dout, a.dout, a.sdo, a.B, a.Sq, a.H);
    if (!err) err = tensor_map<D>(&m.k, a.k, a.sk, a.B, a.Skv, a.Hkv);
    if (!err) err = tensor_map<D>(&m.v, a.v, a.sv, a.B, a.Skv, a.Hkv);
    if (!err) err = tensor_map<D>(&m.dq, a.dq, a.sdq, a.B, a.Sq, a.H);
    if constexpr (D == WIDE) {
      if (!err) err = allow_smem(flash_bwd_dq_wide_kernel, WideDqSmem::BYTES, &done_bf16);
      if (err) return err;
      flash_bwd_dq_wide_kernel<<<n_blocks * a.H * a.B, TC_THREADS, WideDqSmem::BYTES, s>>>(
          m, a, n_blocks);
    } else {
      if (!err) err = allow_smem(flash_bwd_dq_kernel<D>, DqSmem<D>::BYTES, &done_bf16);
      if (err) return err;
      flash_bwd_dq_kernel<D>
          <<<n_blocks * a.H * a.B, TC_THREADS, DqSmem<D>::BYTES, s>>>(m, a, n_blocks);
    }
  } else {
    const int positions = fma_rows<D>() / a.group;  // a block's whole positions
    if (positions == 0) return -2;
    const int n_qt = (a.Sq + positions - 1) / positions;
    int err = allow_smem(flash_bwd_dq_fma_kernel<float, D>, FmaDqSmem<D>::BYTES, &done_f32);
    if (err) return err;
    flash_bwd_dq_fma_kernel<float, D>
        <<<dim3(n_qt, a.Hkv, a.B), NT, FmaDqSmem<D>::BYTES, s>>>(a);
  }
  return (int)cudaGetLastError();
}

Stride stride_at(const long long* s, int i) { return Stride{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

enum Phase { PREPROCESS, DKDV, DQ };

int run(Phase phase, int dtype, int D, const void* q, const void* k, const void* v,
        const void* o, const void* dout, void* dq, void* dk, void* dv, const float* lse,
        float* delta, const long long* strides, int B, int Sq, int Skv, int H, int Hkv,
        int causal, int window, int q_offset, float scale, int n_blocks, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  Args a{q, k, v, o, dout, dq, dk, dv, lse, delta,
         stride_at(strides, 0), stride_at(strides, 1), stride_at(strides, 2),
         stride_at(strides, 3), stride_at(strides, 4), stride_at(strides, 5),
         stride_at(strides, 6), stride_at(strides, 7),
         B, Sq, Skv, H, Hkv, H / Hkv, causal, window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_BWD_PHASE(DD)                                               \
  switch (phase) {                                                         \
    case PREPROCESS: return launch_preprocess<DD>(dtype, a, s);            \
    case DKDV: return launch_dkdv<DD>(dtype, a, n_blocks, s);              \
    default: return launch_dq<DD>(dtype, a, n_blocks, s);                  \
  }
  switch (D) {
    case 16: REPRO_BWD_PHASE(16)
    case 32: REPRO_BWD_PHASE(32)
    case 64: REPRO_BWD_PHASE(64)
    case 80: REPRO_BWD_PHASE(80)
    case 128: REPRO_BWD_PHASE(128)
    case 256: REPRO_BWD_PHASE(256)
  }
#undef REPRO_BWD_PHASE
  return -2;
}

}  // namespace

// C interface, loaded with ctypes; the three phases in order are one
// backward.  dtype: 0 = float32, 1 = bfloat16.  strides: 24 element strides
// (batch, seq, head) of q, k, v, o, dO, dQ, dK, dV; the head dimension must
// be contiguous and every row 16-byte aligned (the Python wrapper checks).
// lse: the forward's (B, H, Sq) log-sum-exps; delta: (B, H, Sq) f32, written
// by the preprocess and read by the other two.  window < 0 disables the
// window.  n_blocks: the bf16 grids' blocks along the sequence, from
// `bwd_plan` (keys for dK/dV, positions for dQ); the preprocess and the f32
// kernels size their own grids.  Each returns 0, a cudaError_t, or -1 / -2 /
// -3 for an unsupported dtype / head dim (or, f32 at D = 256, a group over
// 32) / a tensor map libcuda refused.
#define REPRO_BWD_ENTRY(NAME, PHASE)                                                          \
  extern "C" int NAME(int dtype, int D, const void* q, const void* k, const void* v,         \
                      const void* o, const void* dout, void* dq, void* dk, void* dv,          \
                      const float* lse, float* delta, const long long* strides, int B,        \
                      int Sq, int Skv, int H, int Hkv, int causal, int window, int q_offset,  \
                      float scale, int n_blocks, void* stream) {                              \
    return run(PHASE, dtype, D, q, k, v, o, dout, dq, dk, dv, lse, delta, strides, B, Sq,     \
               Skv, H, Hkv, causal, window, q_offset, scale, n_blocks, stream);               \
  }
REPRO_BWD_ENTRY(repro_flash_bwd_preprocess, PREPROCESS)
REPRO_BWD_ENTRY(repro_flash_bwd_dkdv, DKDV)
REPRO_BWD_ENTRY(repro_flash_bwd_dq, DQ)
#undef REPRO_BWD_ENTRY
