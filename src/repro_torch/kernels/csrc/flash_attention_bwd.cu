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
//  * flash_bwd_dkdv_kernel: one block per (b, kv head, 64 keys).  The block
//    walks the query rows (query position, q head of the group) that can see
//    one of its keys, 32 rows a tile, through a 2-stage cp.async ring; each
//    warp holds 16 keys' dK and dV accumulators (f32) in registers for the
//    whole walk.  S^T = K Q^T and dP^T = V dO^T by mma.sync.m16n8k16 (bf16 ->
//    f32), P^T and dS^T on the accumulator fragments, then dV += P^T dO and
//    dK += dS^T Q with P^T and dS^T repacked to bf16 A fragments in registers
//    (P in f32 for dS, rounded to bf16 for the products, as FlashAttention-2
//    does).  The GQA sum is the walk over the group's rows, so no block
//    writes another's keys.
//  * flash_bwd_dq_kernel: one block per (b, kv head, 64 query rows), the
//    forward's tiling: K/V tiles of 64 keys through a 2-stage ring, each
//    warp's 16 rows of dQ in registers.  S = Q K^T, dP = dO V^T, dS, then
//    dQ += dS K.
//
// Tiles that lie wholly outside the masks are never visited (the walks start
// and end where the causal diagonal and the window allow); masks are
// evaluated only on tiles that cross the diagonal, the window's edge or Skv.
// What bounds it: 5 products of 2.B.H.Sq.Skv.D flops (halved by a causal
// mask) against reading q, k, v, o, dO once and writing dq, dk, dv once; at
// qwen3's training shape (B 8, S 1024, 16/8 heads, D 128) that is 86 GFLOP
// against 0.2 GB, so the tensor cores' rate bounds it.  mma.sync cannot
// reach that rate on Hopper (wgmma can); this first form keeps 16 keys or
// rows a warp, as the forward does, and PERF.md has its time.
//
// f32 (the smoke configurations and the checks) takes plain FMA kernels with
// every tile in shared memory: flash_bwd_dkdv_fma_kernel and
// flash_bwd_dq_fma_kernel, the same walks as the bf16 kernels.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;   // threads per block, every kernel
constexpr int BM = 64;    // keys per dK/dV block; query rows per dQ block
constexpr int BN = 64;    // keys per kv tile of the dQ kernels
constexpr int BQ = 32;    // query rows per tile of the dK/dV kernels
constexpr float LOG2E = 1.4426950408889634f;

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy `nrows` rows of a (ROWS x D) bf16 tile into shared memory (row pitch
// LD) in 16-byte pieces, zero-filling rows [nrows, ROWS).
template <int D, int ROWS, int LD, typename RowPtr>
__device__ __forceinline__ void load_rows_async(bf16* dst, int nrows, RowPtr row_ptr, int tid) {
  constexpr int CH = D / 8;
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r < nrows;
    cp_async16(dst + r * LD + c, ok ? row_ptr(r) + c : row_ptr(0), ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two products every kernel here is made of, for one warp's 16 rows
// (fragment layout of m16n8k16: this lane holds rows g and g + 8, columns
// 2 * t4 and 2 * t4 + 1 of each 8-column block).
//
// acc (16 x 8 NB) += X (16 rows at sX, pitch LD, D wide) . Y^T, Y the NB * 8
// rows at sY: both operands row-major in shared memory, as Q and K are.
template <int D, int NB, int LD>
__device__ __forceinline__ void mma_abt(float (*acc)[4], const bf16* sX, const bf16* sY,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, sX + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t b[4];  // Y rows are B's columns: b0, b1 of blocks 2np, 2np + 1
      ldsm_x4(b, sY + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D) += P (16 x 16 KC, as f32 accumulator fragments of 2 KC
// blocks, rounded to bf16 here) . Z, Z the 16 KC rows at sZ (row-major,
// pitch LD), as V is in the forward's P V.
template <int D, int KC, int LD>
__device__ __forceinline__ void mma_pz(float (*acc)[4], const float (*p)[4], const bf16* sZ,
                                       int lane) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const uint32_t a[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                           pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                           pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                           pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];  // Z^T fragments of column blocks 2dp, 2dp + 1
      ldsm_x4_trans(b, sZ + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                           (2 * dp + (lane >> 4)) * 8);
      mma_bf16(acc[2 * dp], a, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// Row r of a kv head's query rows is query position r / group of q head
// hk * group + r % group.
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

// Write a warp's 16 rows x D f32 accumulator fragments, times `mul`, to the
// rows [row0, row0 + 16) of `out` that are below `nrows`, staged through the
// warp's own 16 rows of shared memory at `stage`.
template <int D, int LD, typename OutPtr>
__device__ __forceinline__ void store_rows(const float (*acc)[4], float mul, bf16* stage,
                                           int row0, int nrows, OutPtr out_row, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(stage + g * LD + c) =
        __floats2bfloat162_rn(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * LD + c) =
        __floats2bfloat162_rn(acc[n][2] * mul, acc[n][3] * mul);
  }
  __syncwarp();
  constexpr int CH = D / 8;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    if (row0 + r >= nrows) continue;
    *reinterpret_cast<uint4*>(out_row(row0 + r) + c) =
        *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
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

// The key tiles [kv_begin, kv_end) that query positions [p0, p0 + nq) see.
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

// ------------------------------------------------------------ bf16 dK, dV --
template <int D>
struct DkvSmem {
  static constexpr int LD = D + 8;  // 16-byte pad: ldmatrix free of bank conflicts
  static constexpr int K = 0, V = BM * LD, Q = 2 * BM * LD;  // Q, dO: 2 stages each
  static constexpr int DO = Q + 2 * BQ * LD;
  static constexpr int STATS = (DO + 2 * BQ * LD) * 2;  // bytes: lse, Delta x 2 stages
  static constexpr int BYTES = STATS + 4 * BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(NT, 2) flash_bwd_dkdv_kernel(Args a) {
  using SM = DkvSmem<D>;
  constexpr int LD = SM::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const sK = reinterpret_cast<bf16*>(smem) + SM::K;
  bf16* const sV = reinterpret_cast<bf16*>(smem) + SM::V;
  bf16* const sQ0 = reinterpret_cast<bf16*>(smem) + SM::Q;
  bf16* const sO0 = reinterpret_cast<bf16*>(smem) + SM::DO;
  float* const sL0 = reinterpret_cast<float*>(smem + SM::STATS);  // lse[2][BQ]
  float* const sD0 = sL0 + 2 * BQ;                                 // Delta[2][BQ]

  // Causal: the first key tiles see the most rows; they go first.
  int lin = blockIdx.x;
  const int hk = lin % a.Hkv;
  lin /= a.Hkv;
  const int b = lin % a.B;
  const int j0 = (lin / a.B) * BM;
  const int nk = min(BM, a.Skv - j0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int group = a.group;
  int r_lo, r_hi;
  rows_seeing(a, j0, nk, &r_lo, &r_hi);

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b + hk * a.sv.h;
  load_rows_async<D, BM, LD>(sK, nk, [&](int r) { return kb + (long long)(j0 + r) * a.sk.s; }, tid);
  load_rows_async<D, BM, LD>(sV, nk, [&](int r) { return vb + (long long)(j0 + r) * a.sv.s; }, tid);
  auto load_rows = [&](int r0, int stage) {
    const int n = min(BQ, r_hi - r0);
    load_rows_async<D, BQ, LD>(sQ0 + stage * BQ * LD, n, [&](int r) {
      return row_ptr<bf16>(a.q, a.sq, b, hk, group, r0 + r);
    }, tid);
    load_rows_async<D, BQ, LD>(sO0 + stage * BQ * LD, n, [&](int r) {
      return row_ptr<bf16>(a.dout, a.sdo, b, hk, group, r0 + r);
    }, tid);
    for (int r = tid; r < BQ; r += NT) {
      sL0[stage * BQ + r] = tile_lse(a, b, hk, r0 + r, r_hi);
      sD0[stage * BQ + r] = r0 + r < r_hi ? a.delta[stat_index(a, b, hk, r0 + r)] : 0.f;
    }
  };
  if (r_lo < r_hi) load_rows(r_lo, 0);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float sl2 = a.scale * LOG2E;

  int stage = 0;
  for (int r0 = r_lo; r0 < r_hi; r0 += BQ, stage ^= 1) {
    __syncthreads();  // every warp is done with the other stage
    if (r0 + BQ < r_hi) load_rows(r0 + BQ, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and this tile have landed
    __syncthreads();
    const bf16* sQ = sQ0 + stage * BQ * LD;
    const bf16* sO = sO0 + stage * BQ * LD;
    const float* sL = sL0 + stage * BQ;
    const float* sD = sD0 + stage * BQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys (unscaled).
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<D, BQ / 8, LD>(s, sK + warp * 16 * LD, sQ, lane);
    mma_abt<D, BQ / 8, LD>(dp, sV + warp * 16 * LD, sO, lane);

    // P^T and dS^T; masks only where the tile crosses a mask's edge.
    const int pos_lo = a.q_offset + r0 / group, pos_hi = a.q_offset + (r0 + BQ - 1) / group;
    const bool full = j0 + BM <= a.Skv && (!a.causal || j0 + BM - 1 <= pos_lo) &&
                      (a.window < 0 || pos_hi - j0 < a.window);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t4 + (e & 1);
        float p = exp2f(fmaf(s[n][e], sl2, -sL[c]));
        if (!full && !valid(a, j0 + warp * 16 + g + 8 * (e >> 1), a.q_offset + (r0 + c) / group))
          p = 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - sD[c]);
      }

    // dV += P^T dO, dK += dS^T Q.
    mma_pz<D, BQ / 16, LD>(dv, s, sO, lane);
    mma_pz<D, BQ / 16, LD>(dk, dp, sQ, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with K, V and the last tile

  bf16* dkb = static_cast<bf16*>(a.dk) + b * a.sdk.b + hk * a.sdk.h;
  bf16* dvb = static_cast<bf16*>(a.dv) + b * a.sdv.b + hk * a.sdv.h;
  const int row0 = warp * 16;
  store_rows<D, LD>(dk, a.scale, sK + row0 * LD, row0, nk,
                    [&](int r) { return dkb + (long long)(j0 + r) * a.sdk.s; }, lane);
  store_rows<D, LD>(dv, 1.f, sV + row0 * LD, row0, nk,
                    [&](int r) { return dvb + (long long)(j0 + r) * a.sdv.s; }, lane);
}

// ------------------------------------------------------------------ bf16 dQ --
template <int D>
struct DqSmem {
  static constexpr int LD = D + 8;
  static constexpr int TILE = BM * LD;  // BM == BN
  static constexpr int Q = 0, DO = TILE, K = 2 * TILE;  // then V, K, V of stage 1
  static constexpr int BYTES = 6 * TILE * 2;
};

template <int D>
__global__ void __launch_bounds__(NT, 2) flash_bwd_dq_kernel(Args a, int n_qt) {
  using SM = DqSmem<D>;
  constexpr int LD = SM::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const sQ = reinterpret_cast<bf16*>(smem) + SM::Q;
  bf16* const sO = reinterpret_cast<bf16*>(smem) + SM::DO;
  bf16* const sK0 = reinterpret_cast<bf16*>(smem) + SM::K;  // K, V of stage s at 2 s TILE

  // Heaviest causal q tiles first, as in the forward.
  int lin = blockIdx.x;
  const int hk = lin % a.Hkv;
  lin /= a.Hkv;
  const int b = lin % a.B;
  const int qt = n_qt - 1 - lin / a.B;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int group = a.group;
  const int positions = BM / group;
  const int p0 = qt * positions;
  const int nq = min(positions, a.Sq - p0);
  const int r0 = p0 * group, nrows = nq * group;
  int kv_begin, kv_end;
  keys_seen(a, p0, nq, &kv_begin, &kv_end);
  const int q_lo = a.q_offset + p0, q_hi = q_lo + nq - 1;

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b + hk * a.sv.h;
  auto load_kv = [&](int j0, int stage) {
    const int nk = min(BN, kv_end - j0);
    load_rows_async<D, BN, LD>(sK0 + 2 * stage * SM::TILE, nk,
                               [&](int r) { return kb + (long long)(j0 + r) * a.sk.s; }, tid);
    load_rows_async<D, BN, LD>(sK0 + (2 * stage + 1) * SM::TILE, nk,
                               [&](int r) { return vb + (long long)(j0 + r) * a.sv.s; }, tid);
  };
  load_rows_async<D, BM, LD>(sQ, nrows, [&](int r) {
    return row_ptr<bf16>(a.q, a.sq, b, hk, group, r0 + r);
  }, tid);
  load_rows_async<D, BM, LD>(sO, nrows, [&](int r) {
    return row_ptr<bf16>(a.dout, a.sdo, b, hk, group, r0 + r);
  }, tid);
  if (kv_begin < kv_end) load_kv(kv_begin, 0);
  cp_async_commit();

  // This lane's rows g and g + 8 of the warp's 16: their statistics.
  float lse_row[2], delta_row[2];
  int pos_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    lse_row[h] = tile_lse(a, b, hk, r0 + r, r0 + nrows);
    delta_row[h] = r < nrows ? a.delta[stat_index(a, b, hk, r0 + r)] : 0.f;
    pos_row[h] = q_lo + r / group;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const float sl2 = a.scale * LOG2E;

  int stage = 0;
  for (int j0 = kv_begin; j0 < kv_end; j0 += BN, stage ^= 1) {
    __syncthreads();  // every warp is done with the other stage
    if (j0 + BN < kv_end) load_kv(j0 + BN, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and this tile have landed
    __syncthreads();
    const bf16* sK = sK0 + 2 * stage * SM::TILE;
    const bf16* sV = sK + SM::TILE;

    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<D, BN / 8, LD>(s, sQ + warp * 16 * LD, sK, lane);
    mma_abt<D, BN / 8, LD>(dp, sO + warp * 16 * LD, sV, lane);

    const bool full = j0 + BN <= a.Skv && (!a.causal || j0 + BN - 1 <= q_lo) &&
                      (a.window < 0 || q_hi - j0 < a.window);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], sl2, -lse_row[e >> 1]));
        if (!full && !valid(a, j0 + n * 8 + 2 * t4 + (e & 1), pos_row[e >> 1])) p = 0.f;
        dp[n][e] = p * (dp[n][e] - delta_row[e >> 1]);
      }
    mma_pz<D, BN / 16, LD>(dq, dp, sK, lane);  // dQ += dS K
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the last tile

  const int row0 = warp * 16;
  store_rows<D, LD>(dq, a.scale, sQ + row0 * LD, row0, nrows, [&](int r) {
    return static_cast<bf16*>(a.dq) + b * a.sdq.b + (long long)((r0 + r) / group) * a.sdq.s +
           (long long)(hk * group + (r0 + r) % group) * a.sdq.h;
  }, lane);
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
  static constexpr int LT = D + 1, LP = BQ + 1;
  static constexpr int K = 0, V = K + BM * LT, DK = V + BM * LT, DV = DK + BM * LT;
  static constexpr int Q = DV + BM * LT, DO = Q + BQ * LT;
  static constexpr int P = DO + BQ * LT, DS = P + BM * LP;
  static constexpr int L = DS + BM * LP, DELTA = L + BQ;
  static constexpr int BYTES = (DELTA + BQ) * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_fma_kernel(Args a) {
  using SM = FmaDkvSmem<D>;
  constexpr int LT = SM::LT, LP = SM::LP;
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

  // Scores: a thread holds key c = tid % BM against 16 of the tile's rows.
  const int c = tid % BM, rb = (tid / BM) * (BQ / 2);
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
    float s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = sK[c * LT + d], vd = sV[c * LT + d];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        s[i] = fmaf(kd, sQ[(rb + i) * LT + d], s[i]);
        dp[i] = fmaf(vd, sO[(rb + i) * LT + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
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
  static constexpr int LT = D + 1, LP = BN + 1;
  static constexpr int Q = 0, DO = Q + BM * LT, DQ = DO + BM * LT;
  static constexpr int K = DQ + BM * LT, V = K + BN * LT, DS = V + BN * LT;
  static constexpr int BYTES = (DS + BM * LP) * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_fma_kernel(Args a) {
  using SM = FmaDqSmem<D>;
  constexpr int LT = SM::LT, LP = SM::LP;
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
  keys_seen(a, p0, nq, &kv_begin, &kv_end);

  load_tile<T, D>(sQ, BM, nrows,
                  [&](int r) { return row_ptr<T>(a.q, a.sq, b, hk, group, r0 + r); }, tid);
  load_tile<T, D>(sO, BM, nrows,
                  [&](int r) { return row_ptr<T>(a.dout, a.sdo, b, hk, group, r0 + r); }, tid);
  for (int i = tid; i < BM * LT; i += NT) sdQ[i] = 0.f;

  // Scores: a thread holds key c = tid % BN against 32 of the block's rows.
  const int c = tid % BN, rb = (tid / BN) * (BM / 2);
  float lse[BM / 2], delta[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) {
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
    float s[BM / 2], dp[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) s[i] = dp[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = sK[c * LT + d], vd = sV[c * LT + d];
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) {
        s[i] = fmaf(sQ[(rb + i) * LT + d], kd, s[i]);
        dp[i] = fmaf(sO[(rb + i) * LT + d], vd, dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) {
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
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, unsigned long long* done) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (*done & bit) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done |= bit;
  return (int)err;
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

template <int D>
int launch_dkdv(int dtype, const Args& a, cudaStream_t s) {
  const int n_kt = (a.Skv + BM - 1) / BM;
  const int blocks = n_kt * a.Hkv * a.B;
  static unsigned long long done_bf16 = 0, done_f32 = 0;
  if (dtype == 1) {
    int err = allow_smem(flash_bwd_dkdv_kernel<D>, DkvSmem<D>::BYTES, &done_bf16);
    if (err) return err;
    flash_bwd_dkdv_kernel<D><<<blocks, NT, DkvSmem<D>::BYTES, s>>>(a);
  } else {
    int err = allow_smem(flash_bwd_dkdv_fma_kernel<float, D>, FmaDkvSmem<D>::BYTES, &done_f32);
    if (err) return err;
    flash_bwd_dkdv_fma_kernel<float, D><<<blocks, NT, FmaDkvSmem<D>::BYTES, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(int dtype, const Args& a, cudaStream_t s) {
  const int positions = BM / a.group;
  const int n_qt = (a.Sq + positions - 1) / positions;
  static unsigned long long done_bf16 = 0, done_f32 = 0;
  if (dtype == 1) {
    int err = allow_smem(flash_bwd_dq_kernel<D>, DqSmem<D>::BYTES, &done_bf16);
    if (err) return err;
    flash_bwd_dq_kernel<D><<<n_qt * a.Hkv * a.B, NT, DqSmem<D>::BYTES, s>>>(a, n_qt);
  } else {
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
        int causal, int window, int q_offset, float scale, void* stream) {
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
    case DKDV: return launch_dkdv<DD>(dtype, a, s);                        \
    default: return launch_dq<DD>(dtype, a, s);                            \
  }
  switch (D) {
    case 16: REPRO_BWD_PHASE(16)
    case 32: REPRO_BWD_PHASE(32)
    case 64: REPRO_BWD_PHASE(64)
    case 128: REPRO_BWD_PHASE(128)
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
// window.  Each returns 0, a cudaError_t, or -1 / -2 for an unsupported
// dtype / head dim.
#define REPRO_BWD_ENTRY(NAME, PHASE)                                                          \
  extern "C" int NAME(int dtype, int D, const void* q, const void* k, const void* v,         \
                      const void* o, const void* dout, void* dq, void* dk, void* dv,          \
                      const float* lse, float* delta, const long long* strides, int B,        \
                      int Sq, int Skv, int H, int Hkv, int causal, int window, int q_offset,  \
                      float scale, void* stream) {                                            \
    return run(PHASE, dtype, D, q, k, v, o, dout, dq, dk, dv, lse, delta, strides, B, Sq,     \
               Skv, H, Hkv, causal, window, q_offset, scale, stream);                         \
  }
REPRO_BWD_ENTRY(repro_flash_bwd_preprocess, PREPROCESS)
REPRO_BWD_ENTRY(repro_flash_bwd_dkdv, DKDV)
REPRO_BWD_ENTRY(repro_flash_bwd_dq, DQ)
#undef REPRO_BWD_ENTRY
