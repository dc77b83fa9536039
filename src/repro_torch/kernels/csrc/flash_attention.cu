// Flash attention forward for Hopper (sm_90a), K1 of the port.
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` / `_flash_kernel`
// in src/repro/kernels/flash_attention.py, and computes what the model path
// needs beyond it: the model's (B, S, H, D) layout read through strides, a
// query offset read from device memory (decode against a KV cache, with no
// host sync), causal and sliding-window masks, and a ragged Skv.
//
// Semantics (those of repro.models.layers.flash_attention): scores q.k^T/sqrt(D)
// in f32, masked keys excluded, softmax with a running max m, a sum l and an
// f32 accumulator; p is cast to v's dtype before the PV product; output
// acc / max(l, 1e-37) in q's dtype, so a row with no valid key is 0.  GQA
// without copies: the `group` q heads that share a kv head are handled by
// one block, so each K/V row is read from device memory once per group.
//
// Three kernels, two C entry points (the Python wrapper picks by Sq):
//
//  * flash_prefill_kernel (Sq > 1, bf16): FlashAttention-2 on Hopper's
//    tensor cores.  A block holds 64 rows, (query position, q head) pairs,
//    4 warps of 16.  Each warp keeps its Q fragments, its S tile and its
//    f32 O accumulator in registers for the whole kv loop: S = Q K^T by
//    mma.sync.m16n8k16 (bf16 -> f32), the online softmax on the accumulator
//    fragments (row max and sum over the 4 lanes of a quad), P repacked to
//    bf16 A fragments in registers, V read with ldmatrix.trans.  K/V tiles of
//    64 keys (32 at D = 256, where Q stays in shared memory: PrefillSmem)
//    move through a 2-stage cp.async ring (rows padded by 16 bytes,
//    so ldmatrix is free of bank conflicts), the next tile's loads in flight
//    while this one is computed.  Masks are evaluated only on the tiles that
//    cross the causal diagonal, the window's edge or Skv.  The heaviest
//    causal q tiles are launched first.  At qwen3's 4 x 512 the work is
//    4.3 GFLOP (4.4 us at the bf16 peak, about 6.6 us at two thirds of it
//    by mma.sync) on 25 MB (7.5 us at 3.35 TB/s): what sets the time at
//    this size is latency and occupancy (3 blocks of 128 threads per SM,
//    512 blocks), not the MMA rate, so wgmma would buy little here.
//  * flash_decode_kernel (Sq = 1, bf16 or f32): split-KV in one launch.
//    Decode reads the live cache once and does 2 flops per element read, so
//    it is bound by bytes; the tensor cores would only add padding (a GQA
//    group of 2 fills 2 of an MMA's 16 rows).  Grid (n_splits, Hkv, B),
//    n_splits fixed by the host from the cache capacity Skv and SPLIT keys,
//    so the host never reads the device offset.  Every block reads the
//    offset and so knows which splits are live; a block whose keys lie past
//    the live length or before the window holds an empty partial (m = -inf,
//    l = 0), which adds nothing, so it exits at once.  A live block issues
//    all its K/V loads at once (16-byte cp.async) and computes its group's
//    rows on CUDA cores in f32.  One live split is the whole answer, and it
//    is written out.  Otherwise the partial (m, l, acc) goes to scratch, then
//    __threadfence() and a ticket per (b, kv head): the live block that
//    takes the last ticket merges the partials in split order
//    (deterministic), writes the output and sets the ticket back to 0.
//    Asked for it, the block that writes a row's output also writes its
//    log-sum-exp from the (m, l) it holds (sequence-parallel decode merges
//    the shards' outputs with it); a row with no live key gets -inf.
//  * flash_prefill_f32_kernel (Sq > 1, f32): the plain FMA path, with S,
//    P and the accumulator in shared memory; it serves the f32 checks.
//
// Head dims 16, 32, 64, 80, 128 and 256 (80: zamba2's shared attention,
// 256: gemma3's).  The kernels need D to be a multiple of 16 and nothing
// more: fragments and loops run over D / 16 MMA k-steps, D / 8 accumulator
// blocks and 16-byte pieces, and f32 loops stride D by 32 lanes with a
// ragged last pass.  A padded row of D = 80 is 11 pieces of 16 bytes, odd
// as at D = 128 and 256 (33), so the 8 rows an ldmatrix reads still start
// in 8 different bank groups.  D = 256 changes two plans at compile time
// (PrefillSmem, F32Smem): the bf16 prefill keeps Q in shared memory and
// walks kv tiles of 32 keys, the f32 prefill walks tiles of 32 keys.
//
// For training, both prefill kernels can also write each row's
// log-sum-exp, the statistic the backward (flash_attention_bwd.cu)
// recomputes P from: lse[b, h, i] = log2(sum_j exp2(s_ij * log2(e))) with
// s = q.k^T/sqrt(D), that is the natural log-sum-exp times log2(e), in the
// base-2 units the bf16 kernel works in; -inf for a row with no valid key.
// In the bf16 kernel it is a template flag, so the serving instantiation
// carries no extra store.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;      // threads per block, every kernel
constexpr int NWARPS = NT / 32;
constexpr int BM = 64;       // prefill rows per block: (query position, q head)
constexpr int SPLIT = 64;    // decode keys per split (DECODE_SPLIT in the wrapper)
constexpr int MAX_GROUP = 64;

// Element strides (batch, seq, head) of q, k, v, o; the head dim is contiguous.
struct Strides {
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16-byte asynchronous copy global -> shared; with ok false the 16 bytes are
// zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy `nrows` rows of a (ROWS x D) tile into shared memory (row pitch LD
// elements) in 16-byte pieces, zero-filling rows [nrows, ROWS).
template <typename T, int D, int ROWS, int LD, typename RowPtr>
__device__ __forceinline__ void load_rows_async(T* dst, int nrows, RowPtr row_ptr, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = D / VEC;
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * VEC;
    const bool ok = r < nrows;
    cp_async16(dst + r * LD + c, ok ? row_ptr(r) + c : row_ptr(0), ok);
  }
}

// ------------------------------------------------------------------ prefill --
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

// The plan of a prefill block by head dim: K and V tiles for each of 2
// stages, and Q.  D <= 128: tiles of 64 keys; Q lands in stage 1's K tile
// and each warp reads its A fragments into registers before that stage's
// first load; 3 blocks of 128 threads an SM, at most 168 registers a
// thread (ptxas spills a few bytes at D = 128) and 3 x 69,632 B.  D = 256:
// a warp's Q fragments (64 registers) beside its accumulator (128) and S
// tile would pass 168, so Q keeps a region of its own and each k-step reads
// its A fragment by ldmatrix; tiles of 32 keys (a 16-register S tile) keep
// the block at 101,376 B, 2 blocks an SM, up to 255 registers a thread.
// Rows are padded by 16 bytes: the 8 rows an ldmatrix reads then start in
// 8 different 16-byte bank groups.
template <int D>
struct PrefillSmem {
  static constexpr bool Q_SMEM = D > 128;  // Q read from shared memory at each k-step
  static constexpr int BN = Q_SMEM ? 32 : 64;  // keys per kv tile
  static constexpr int BLOCKS = Q_SMEM ? 2 : 3;  // blocks an SM (launch bounds)
  static constexpr int LD = D + 8;
  static constexpr int TILE = BN * LD;  // elements of a K or V tile
  static constexpr int Q = Q_SMEM ? 4 * TILE : 2 * TILE;  // Q's offset (elements)
  static constexpr int BYTES = (Q_SMEM ? Q + BM * LD : 4 * TILE) * (int)sizeof(bf16);
};

template <int D, bool LSE>
__global__ void __launch_bounds__(NT, PrefillSmem<D>::BLOCKS)
flash_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, Strides st, int B,
                     int Sq, int Skv, int Hkv, int group, int n_qt, int causal, int window,
                     const int* __restrict__ q_offset_dev, int q_offset, float scale_log2,
                     float* __restrict__ lse) {
  using SM = PrefillSmem<D>;
  constexpr int LD = SM::LD, BN = SM::BN;  // this D's kv tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const sK0 = reinterpret_cast<bf16*>(smem);
  bf16* const sV0 = sK0 + SM::TILE;
  bf16* const sQ = sK0 + SM::Q;  // stage 1's K tile, or Q's own region

  // Heaviest causal q tiles first: the q tile is the slowest index of a
  // linear grid, counted down.
  int lin = blockIdx.x;
  const int hk = lin % Hkv;
  lin /= Hkv;
  const int b = lin % B;
  const int qt = n_qt - 1 - lin / B;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int positions = BM / group;  // query positions per block
  const int q0 = qt * positions;
  const int nq = min(positions, Sq - q0);
  const int nrows = nq * group;      // rows in use; the rest are padding
  const int off = q_offset + (q_offset_dev ? *q_offset_dev : 0);
  const int q_lo = off + q0, q_hi = q_lo + nq - 1;  // absolute positions
  const int kv_end = causal ? min(Skv, q_hi + 1) : Skv;
  const int kv_begin = (window >= 0 ? max(0, q_lo - window + 1) : 0) / BN * BN;

  const bf16* kb = k + b * st.k_b + hk * st.k_h;
  const bf16* vb = v + b * st.v_b + hk * st.v_h;
  auto load_kv = [&](int j0, int stage) {
    const int nk = min(BN, kv_end - j0);
    load_rows_async<bf16, D, BN, LD>(sK0 + 2 * stage * SM::TILE, nk,
                                     [&](int r) { return kb + (long long)(j0 + r) * st.k_s; }, tid);
    load_rows_async<bf16, D, BN, LD>(sV0 + 2 * stage * SM::TILE, nk,
                                     [&](int r) { return vb + (long long)(j0 + r) * st.v_s; }, tid);
  };

  // Row r is query position q0 + r / group of q head hk * group + r % group.
  load_rows_async<bf16, D, BM, LD>(sQ, nrows, [&](int r) {
    return q + b * st.q_b + (long long)(q0 + r / group) * st.q_s +
           (long long)(hk * group + r % group) * st.q_h;
  }, tid);
  cp_async_commit();
  if (kv_begin < kv_end) load_kv(kv_begin, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  // This warp's Q as A fragments, one per 16 of D (lanes 0-15 address rows
  // 0-15 at column 0 of the chunk, lanes 16-31 the same rows at column 8):
  // all of them kept, or (Q_SMEM) one, read again at each k-step.
  uint32_t qf[SM::Q_SMEM ? 1 : D / 16][4];
  if constexpr (!SM::Q_SMEM) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // This lane holds rows g and g + 8 of the warp's 16 (fragment layout).
  const int g = lane >> 2, t4 = lane & 3;
  const int pos_row[2] = {q_lo + (warp * 16 + g) / group, q_lo + (warp * 16 + g + 8) / group};
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};  // this lane's part of the row sums

  int stage = 0;
  for (int j0 = kv_begin; j0 < kv_end; j0 += BN, stage ^= 1) {
    __syncthreads();  // every warp is done with the other stage's tile
    if (j0 + BN < kv_end) load_kv(j0 + BN, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const bf16* sK = sK0 + 2 * stage * SM::TILE;
    const bf16* sV = sV0 + 2 * stage * SM::TILE;

    // S = Q K^T (unscaled): BN / 8 blocks of 8 keys, 4 floats each.
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if constexpr (SM::Q_SMEM)
        ldsm_x4(qf[0], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      const uint32_t* const a = qf[SM::Q_SMEM ? 0 : kk];
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t bk[4];  // K rows are B's columns: b0, b1 of key blocks 2np, 2np+1
        ldsm_x4(bk, sK + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // Masks, only where the tile crosses the diagonal, the window's edge or Skv.
    const bool full = j0 + BN <= Skv && (!causal || j0 + BN - 1 <= q_lo) &&
                      (window < 0 || q_hi - j0 < window);
    if (!full) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kv = j0 + n * 8 + 2 * t4 + (e & 1), pos = pos_row[e >> 1];
          bool ok = kv < Skv;
          if (causal) ok = ok && kv <= pos;
          if (window >= 0) ok = ok && pos - kv < window;
          if (!ok) s[n][e] = -INFINITY;
        }
    }

    // Online softmax on the fragments; a row's BN scores sit on one quad.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m_row[h];
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_safe = mx == -INFINITY ? 0.f : mx;  // no valid key so far
      const float alpha = m_row[h] == -INFINITY ? 0.f : exp2f((m_row[h] - m_safe) * scale_log2);
      const float shift = m_safe * scale_log2;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[n][e] = exp2f(fmaf(s[n][e], scale_log2, -shift));  // -inf -> 0
          sum += s[n][e];
        }
      l_row[h] = l_row[h] * alpha + sum;
      m_row[h] = mx;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * h] *= alpha;
        acc[n][2 * h + 1] *= alpha;
      }
    }

    // O += P V: P (16 x BN) repacked to bf16 A fragments, one per 16 keys.
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];  // V^T fragments of d blocks 2dp, 2dp+1
        ldsm_x4_trans(bv, sV + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                              (2 * dp + (lane >> 4)) * 8);
        mma_bf16(acc[2 * dp], a, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the last tile

  // Epilogue: each warp stages its 16 rows in its own rows of sQ, then
  // writes them out in 16-byte pieces.
  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_row[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[h] = fmaxf(l, 1e-37f);
    if (LSE && t4 == 0) {  // (B, H, Sq), base 2; -inf where no key is valid
      const int row = warp * 16 + g + 8 * h;
      if (row < nrows)
        lse[((long long)b * Hkv * group + hk * group + row % group) * Sq + q0 + row / group] =
            l > 0.f ? fmaf(m_row[h], scale_log2, log2f(l)) : -INFINITY;
    }
  }
  bf16* sO = sQ + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(sO + g * LD + c) =
        __floats2bfloat162_rn(acc[n][0] / den[0], acc[n][1] / den[0]);
    *reinterpret_cast<__nv_bfloat162*>(sO + (g + 8) * LD + c) =
        __floats2bfloat162_rn(acc[n][2] / den[1], acc[n][3] / den[1]);
  }
  __syncwarp();
  constexpr int CH = D / 8;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8, row = warp * 16 + r;
    if (row >= nrows) continue;
    *reinterpret_cast<uint4*>(o + b * st.o_b + (long long)(q0 + row / group) * st.o_s +
                              (long long)(hk * group + row % group) * st.o_h + c) =
        *reinterpret_cast<const uint4*>(sO + r * LD + c);
  }
}

// -------------------------------------------------------------- f32 prefill --
// The f32 prefill's shared memory.  Tiles of 64 keys, or of 32 at D = 256,
// where 64 would take 284,160 B (a block may have 232,448); that plan takes
// 209,408 B.
template <int D>
struct F32Smem {
  static constexpr int BN = D > 128 ? 32 : 64;  // keys per kv tile
  static constexpr int LDT = D + 4;   // q, k, v tiles
  static constexpr int LDS = BN + 4;  // scores, then probabilities
  static constexpr int Q = 0;
  static constexpr int K = Q + BM * LDT * 4;
  static constexpr int V = K + BN * LDT * 4;
  static constexpr int S = V + BN * LDT * 4;
  static constexpr int O = S + BM * LDS * 4;
  static constexpr int M = O + BM * LDT * 4;
  static constexpr int L = M + BM * 4;
  static constexpr int BYTES = L + BM * 4;
};

template <int D>
__global__ void __launch_bounds__(NT)
flash_prefill_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, Strides st,
                         int Sq, int Skv, int group, int causal, int window,
                         const int* __restrict__ q_offset_dev, int q_offset, float scale,
                         float* __restrict__ lse) {
  using SM = F32Smem<D>;
  constexpr int LDT = SM::LDT, LDS = SM::LDS, RPW = BM / NWARPS, BN = SM::BN;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + SM::Q);
  float* sK = reinterpret_cast<float*>(smem + SM::K);
  float* sV = reinterpret_cast<float*>(smem + SM::V);
  float* sS = reinterpret_cast<float*>(smem + SM::S);
  float* sO = reinterpret_cast<float*>(smem + SM::O);
  float* sM = reinterpret_cast<float*>(smem + SM::M);
  float* sL = reinterpret_cast<float*>(smem + SM::L);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int positions = BM / group;
  const int q0 = blockIdx.x * positions;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int nq = min(positions, Sq - q0);
  const int nrows = nq * group;
  const int off = q_offset + (q_offset_dev ? *q_offset_dev : 0);

  load_rows_async<float, D, BM, LDT>(sQ, nrows, [&](int r) {
    return q + b * st.q_b + (long long)(q0 + r / group) * st.q_s +
           (long long)(hk * group + r % group) * st.q_h;
  }, tid);
  cp_async_commit();
  for (int r = tid; r < BM; r += NT) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }
  for (int i = tid; i < BM * D; i += NT) sO[(i / D) * LDT + i % D] = 0.f;

  const int q_lo = off + q0, q_hi = off + q0 + nq - 1;
  const int kv_end = causal ? min(Skv, q_hi + 1) : Skv;
  const int kv_begin = (window >= 0 ? max(0, q_lo - window + 1) : 0) / BN * BN;

  for (int j0 = kv_begin; j0 < kv_end; j0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    const int nk = min(BN, kv_end - j0);
    load_rows_async<float, D, BN, LDT>(sK, nk, [&](int r) {
      return k + b * st.k_b + (long long)(j0 + r) * st.k_s + hk * st.k_h;
    }, tid);
    load_rows_async<float, D, BN, LDT>(sV, nk, [&](int r) {
      return v + b * st.v_b + (long long)(j0 + r) * st.v_s + hk * st.v_h;
    }, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      const int pos = off + q0 + r / group;
      const float* qrow = sQ + r * LDT;
      float s[BN / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < BN / 32; ++t) {
        const int c = lane + 32 * t, kv = j0 + c;
        bool ok = r < nrows && kv < kv_end;
        if (causal) ok = ok && kv <= pos;
        if (window >= 0) ok = ok && (pos - kv) < window;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qrow[d], sK[c * LDT + d], dot);
        s[t] = ok ? dot * scale : -INFINITY;
        mx = fmaxf(mx, s[t]);
      }
      mx = warp_max(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < BN / 32; ++t) {
        const float p = s[t] == -INFINITY ? 0.f : expf(s[t] - m_safe);
        psum += p;
        sS[r * LDS + lane + 32 * t] = p;
      }
      psum = warp_sum(psum);
      const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_safe);
      __syncwarp();
      for (int d = lane; d < D; d += 32) {
        float a = sO[r * LDT + d] * alpha;
#pragma unroll 8
        for (int c = 0; c < BN; ++c) a = fmaf(sS[r * LDS + c], sV[c * LDT + d], a);
        sO[r * LDT + d] = a;
      }
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + psum;
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int i = tid; i < BM * D; i += NT) {
    const int r = i / D, d = i % D;
    if (r >= nrows) continue;
    o[b * st.o_b + (long long)(q0 + r / group) * st.o_s + (long long)(hk * group + r % group) * st.o_h +
      d] = sO[r * LDT + d] / fmaxf(sL[r], 1e-37f);
  }
  if (lse != nullptr)  // (B, H, Sq), base 2; -inf where no key is valid
    for (int r = tid; r < nrows; r += NT)
      lse[((long long)b * gridDim.y * group + hk * group + r % group) * Sq + q0 + r / group] =
          sL[r] > 0.f ? (sM[r] + logf(sL[r])) * 1.4426950408889634f : -INFINITY;
}

// ------------------------------------------------------------------- decode --
template <typename T> __device__ __forceinline__ void unpack16(const uint4& u, float* f);
template <> __device__ __forceinline__ void unpack16<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack16<bf16>(const uint4& u, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is exact: the high 16 bits
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename T, int D>
struct DecodeSmem {
  static constexpr int LD = D + 16 / (int)sizeof(T);  // K, V rows, 16-byte pad
  static constexpr int K = 0;
  static constexpr int V = K + SPLIT * LD * (int)sizeof(T);
  static constexpr int Q = V + SPLIT * LD * (int)sizeof(T);
  static constexpr int KV_FLOATS = Q / 4;  // what the merge reuses of K and V
  static int bytes(int group) { return Q + group * (D + SPLIT) * 4; }  // Q, then S
};

// Scratch per (b, kv head, split): m[group], l[group], acc[group][D] (f32).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, Strides st, int Skv, int Hkv, int group, int causal,
                    int window, const int* __restrict__ q_offset_dev, int q_offset, float scale,
                    float* __restrict__ scratch, int* __restrict__ tickets,
                    float* __restrict__ lse, float* __restrict__ o32) {
  using SM = DecodeSmem<T, D>;
  constexpr int LD = SM::LD, VEC = 16 / sizeof(T), D2 = D / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + SM::K);
  T* sV = reinterpret_cast<T*>(smem + SM::V);
  float* sQ = reinterpret_cast<float*>(smem + SM::Q);
  float* sS = sQ + group * D;
  __shared__ float sM[MAX_GROUP], sL[MAX_GROUP];
  __shared__ int s_last;

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pos = q_offset + (q_offset_dev ? *q_offset_dev : 0);
  const int kv_end = causal ? min(Skv, pos + 1) : Skv;
  const int kv_begin = window >= 0 ? max(0, pos - window + 1) : 0;
  // The live keys [kv_begin, kv_end) fall in the splits [s_lo, s_hi); every
  // block reads the same offset, so all agree on them.
  const int s_lo = kv_begin / SPLIT;
  const int s_hi = kv_begin < kv_end ? (kv_end - 1) / SPLIT + 1 : s_lo;
  const int n_live = s_hi - s_lo;
  T* const ob = o + b * st.o_b + (long long)hk * group * st.o_h;
  // o32, when given, takes the output in f32 instead of o (same strides):
  // sequence-parallel decode merges its shards' outputs before rounding.
  float* const ob32 = o32 ? o32 + b * st.o_b + (long long)hk * group * st.o_h : nullptr;
  auto put = [&](long long at, float x, float y) {
    if (ob32) store2(ob32 + at, x, y);
    else store2(ob + at, x, y);
  };
  // lse (B, H) when asked: the rows' natural log-sum-exp times log2(e),
  // -inf where no key is live (lse_plain's units, the prefill's).
  float* const lb = lse ? lse + ((long long)b * Hkv + hk) * group : nullptr;
  constexpr float LOG2E = 1.4426950408889634f;
  if (split < s_lo || split >= s_hi) {  // an empty partial: it adds nothing
    if (n_live == 0 && split == 0) {    // no live key at all: the output is 0
      for (int i = tid; i < group * D2; i += NT)
        put((i / D2) * st.o_h + (i % D2) * 2, 0.f, 0.f);
      if (lb)
        for (int r = tid; r < group; r += NT) lb[r] = -INFINITY;
    }
    return;
  }
  const int lo = max(kv_begin, split * SPLIT), hi = min(kv_end, split * SPLIT + SPLIT);
  const int n = hi - lo;  // live keys of this split, at least 1

  // All of the split's K and V rows in flight at once.
  load_rows_async<T, D, SPLIT, LD>(sK, n, [&](int r) {
    return k + b * st.k_b + (long long)(lo + r) * st.k_s + hk * st.k_h;
  }, tid);
  load_rows_async<T, D, SPLIT, LD>(sV, n, [&](int r) {
    return v + b * st.v_b + (long long)(lo + r) * st.v_s + hk * st.v_h;
  }, tid);
  cp_async_commit();
  for (int i = tid; i < group * D; i += NT) {
    const int r = i / D, d = i % D;
    sQ[i] = to_f(q[b * st.q_b + (long long)(hk * group + r) * st.q_h + d]);
  }
  cp_async_wait<0>();
  __syncthreads();

  // Scores of the group's rows against the split's keys, f32 on CUDA cores.
  for (int i = tid; i < group * n; i += NT) {
    const int r = i / n, c = i - r * n;
    const float* qr = sQ + r * D;
    const T* kr = sK + c * LD;
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += VEC) {
      float kf[VEC];
      unpack16<T>(*reinterpret_cast<const uint4*>(kr + d), kf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) dot = fmaf(qr[d + e], kf[e], dot);
    }
    sS[r * SPLIT + c] = dot * scale;
  }
  __syncthreads();

  // The split's softmax statistics; p is kept in v's dtype for PV.
  const int stride = group * (D + 2);
  float* const part0 = scratch + (long long)(b * Hkv + hk) * gridDim.x * stride;
  float* const part = part0 + (long long)split * stride;  // m, l, acc
  for (int r = warp; r < group; r += NWARPS) {
    float* sr = sS + r * SPLIT;
    float mx = -INFINITY;
    for (int c = lane; c < n; c += 32) mx = fmaxf(mx, sr[c]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float p = expf(sr[c] - mx);
      sum += p;
      sr[c] = to_f(from_f<T>(p));
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      sM[r] = mx;
      sL[r] = sum;
      if (lb && n_live == 1) lb[r] = (mx + logf(sum)) * LOG2E;
      if (n_live > 1) {
        part[r] = mx;
        part[group + r] = sum;
      }
    }
  }
  __syncthreads();

  // acc = P V, two neighbouring head-dim columns a thread.  One live split
  // is the whole answer (the merge's weight would be 1): write it out.
  for (int i = tid; i < group * D2; i += NT) {
    const int r = i / D2, d = (i % D2) * 2;
    const float* sr = sS + r * SPLIT;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const float2 x = load2(sV + c * LD + d);
      a0 = fmaf(sr[c], x.x, a0);
      a1 = fmaf(sr[c], x.y, a1);
    }
    if (n_live == 1) {
      const float den = fmaxf(sL[r], 1e-37f);
      put(r * st.o_h + d, a0 / den, a1 / den);
    } else {
      store2(part + 2 * group + r * D + d, a0, a1);
    }
  }
  if (n_live == 1) return;

  // Publish the partial, then take a ticket; the last live block merges.
  __threadfence();
  __syncthreads();
  int* ticket = tickets + b * Hkv + hk;
  if (tid == 0) s_last = atomicAdd(ticket, 1) == n_live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // Merge the live splits in split order (deterministic), reading past this
  // SM's L1 (__ldcg).  M first (a max, exact in any order); then, a chunk of
  // splits at a time, their weights exp(m - M) and l into the K/V space, and
  // L and the accumulators (in sQ's space) summed in split order.
  for (int r = warp; r < group; r += NWARPS) {
    float mx = -INFINITY;
    for (int s = s_lo + lane; s < s_hi; s += 32) mx = fmaxf(mx, __ldcg(part0 + s * stride + r));
    mx = warp_max(mx);
    if (lane == 0) {
      sM[r] = mx;
      sL[r] = 0.f;
    }
  }
  float* sA = sQ;
  for (int i = tid; i < group * D; i += NT) sA[i] = 0.f;
  const int chunk = SM::KV_FLOATS / (2 * group);
  float* sW = reinterpret_cast<float*>(smem);
  float* sLs = sW + chunk * group;
  __syncthreads();
  for (int c0 = s_lo; c0 < s_hi; c0 += chunk) {
    const int nc = min(chunk, s_hi - c0);
    for (int i = tid; i < nc * group; i += NT) {
      const int j = i / group, r = i % group;
      const float* p = part0 + (long long)(c0 + j) * stride;
      sW[i] = expf(__ldcg(p + r) - sM[r]);
      sLs[i] = __ldcg(p + group + r);
    }
    __syncthreads();
    for (int r = tid; r < group; r += NT) {
      float L = sL[r];
      for (int j = 0; j < nc; ++j) L = fmaf(sW[j * group + r], sLs[j * group + r], L);
      sL[r] = L;
    }
    for (int i = tid; i < group * D2; i += NT) {
      const int r = i / D2, d = (i % D2) * 2;
      float2 a = *reinterpret_cast<const float2*>(sA + r * D + d);
      const float* p = part0 + (long long)c0 * stride + 2 * group + r * D + d;
#pragma unroll 8
      for (int j = 0; j < nc; ++j) {
        const float w = sW[j * group + r];
        const float2 x = __ldcg(reinterpret_cast<const float2*>(p + (long long)j * stride));
        a.x = fmaf(w, x.x, a.x);
        a.y = fmaf(w, x.y, a.y);
      }
      *reinterpret_cast<float2*>(sA + r * D + d) = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < group * D2; i += NT) {
    const int r = i / D2, d = (i % D2) * 2;
    const float den = fmaxf(sL[r], 1e-37f);
    put(r * st.o_h + d, sA[r * D + d] / den, sA[r * D + d + 1] / den);
  }
  if (lb)
    for (int r = tid; r < group; r += NT) lb[r] = (sM[r] + logf(sL[r])) * LOG2E;
  if (tid == 0) *ticket = 0;  // ready for the next launch
}

// ----------------------------------------------------------------- launchers --
// Raise a kernel's dynamic shared memory limit once per device (`done` is a
// bit per device), not on every launch.
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

template <int D, bool LSE>
int launch_prefill_bf16(const void* q, const void* k, const void* v, void* o, const Strides& st,
                        int B, int Sq, int Skv, int Hkv, int group, int n_qt, int causal,
                        int window, const int* q_offset_dev, int q_offset, float scale,
                        float* lse, cudaStream_t stream) {
  constexpr int bytes = PrefillSmem<D>::BYTES;
  static unsigned long long done = 0;
  int err = allow_smem(flash_prefill_kernel<D, LSE>, bytes, &done);
  if (err) return err;
  const float log2e = 1.4426950408889634f;
  flash_prefill_kernel<D, LSE><<<n_qt * Hkv * B, NT, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), st, B, Sq, Skv, Hkv, group, n_qt, causal, window, q_offset_dev,
      q_offset, scale * log2e, lse);
  return 0;
}

template <int D>
int launch_prefill(int dtype, const void* q, const void* k, const void* v, void* o,
                   const Strides& st, int B, int Sq, int Skv, int H, int Hkv, int causal,
                   int window, const int* q_offset_dev, int q_offset, float scale, float* lse,
                   cudaStream_t stream) {
  const int group = H / Hkv;
  const int positions = BM / group;
  const int n_qt = (Sq + positions - 1) / positions;
  if (dtype == 1) {
    const int err = lse ? launch_prefill_bf16<D, true>(q, k, v, o, st, B, Sq, Skv, Hkv, group,
                                                       n_qt, causal, window, q_offset_dev,
                                                       q_offset, scale, lse, stream)
                        : launch_prefill_bf16<D, false>(q, k, v, o, st, B, Sq, Skv, Hkv, group,
                                                        n_qt, causal, window, q_offset_dev,
                                                        q_offset, scale, nullptr, stream);
    if (err) return err;
  } else {
    constexpr int bytes = F32Smem<D>::BYTES;
    static unsigned long long done = 0;
    int err = allow_smem(flash_prefill_f32_kernel<D>, bytes, &done);
    if (err) return err;
    flash_prefill_f32_kernel<D><<<dim3(n_qt, Hkv, B), NT, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), st, Sq, Skv, group, causal,
        window, q_offset_dev, q_offset, scale, lse);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_decode(const void* q, const void* k, const void* v, void* o, const Strides& st,
                  int B, int Skv, int H, int Hkv, int causal, int window,
                  const int* q_offset_dev, int q_offset, float scale, float* scratch,
                  int* tickets, int n_splits, float* lse, float* o32,
                  cudaStream_t stream) {
  const int group = H / Hkv;
  const int bytes = DecodeSmem<T, D>::bytes(group);
  static unsigned long long done = 0;
  int err = allow_smem(flash_decode_kernel<T, D>, DecodeSmem<T, D>::bytes(MAX_GROUP), &done);
  if (err) return err;
  flash_decode_kernel<T, D><<<dim3(n_splits, Hkv, B), NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), st, Skv, Hkv, group, causal, window, q_offset_dev, q_offset, scale,
      scratch, tickets, lse, o32);
  return (int)cudaGetLastError();
}

Strides to_strides(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
}

}  // namespace

// C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// strides: 12 element strides (batch, seq, head) of q, k, v, o; the head
// dimension must be contiguous and every row 16-byte aligned (the Python
// wrapper checks).  window < 0 disables the window.  The query offset is
// q_offset plus *q_offset_dev when that pointer is not null.  Each returns
// 0, a cudaError_t, or -1 / -2 for an unsupported dtype / head dim.

// Sq > 1: the tensor-core kernel for bf16, the FMA kernel for f32.  lse,
// when not null, receives (B, H, Sq) f32 log-sum-exps (base 2, see above).
extern "C" int repro_flash_prefill(int dtype, int D, const void* q, const void* k,
                                   const void* v, void* o, const long long* strides, int B,
                                   int Sq, int Skv, int H, int Hkv, int causal, int window,
                                   const int* q_offset_dev, int q_offset, float scale,
                                   float* lse, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  const Strides st = to_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_prefill<16>(dtype, q, k, v, o, st, B, Sq, Skv, H, Hkv, causal, window, q_offset_dev, q_offset, scale, lse, s);
    case 32: return launch_prefill<32>(dtype, q, k, v, o, st, B, Sq, Skv, H, Hkv, causal, window, q_offset_dev, q_offset, scale, lse, s);
    case 64: return launch_prefill<64>(dtype, q, k, v, o, st, B, Sq, Skv, H, Hkv, causal, window, q_offset_dev, q_offset, scale, lse, s);
    case 80: return launch_prefill<80>(dtype, q, k, v, o, st, B, Sq, Skv, H, Hkv, causal, window, q_offset_dev, q_offset, scale, lse, s);
    case 128: return launch_prefill<128>(dtype, q, k, v, o, st, B, Sq, Skv, H, Hkv, causal, window, q_offset_dev, q_offset, scale, lse, s);
    case 256: return launch_prefill<256>(dtype, q, k, v, o, st, B, Sq, Skv, H, Hkv, causal, window, q_offset_dev, q_offset, scale, lse, s);
    default: return -2;
  }
}

// Sq = 1, split-KV.  scratch holds B * Hkv * n_splits * group * (D + 2)
// floats; tickets B * Hkv ints, zero before the launch and zero after it.
// lse, when not null, receives (B, H) f32 log-sum-exps in the prefill's
// units (-inf for a row with no live key: a query offset below 0, or a
// window past the keys).  o32, when not null, receives the output in f32
// instead of o (the strides are o's).
extern "C" int repro_flash_decode(int dtype, int D, const void* q, const void* k, const void* v,
                                  void* o, const long long* strides, int B, int Skv, int H,
                                  int Hkv, int causal, int window, const int* q_offset_dev,
                                  int q_offset, float scale, float* scratch, int* tickets,
                                  int n_splits, float* lse, float* o32,
                                  void* stream) {
  const Strides st = to_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE(T, DD)                                                                  \
  return launch_decode<T, DD>(q, k, v, o, st, B, Skv, H, Hkv, causal, window, q_offset_dev, \
                              q_offset, scale, scratch, tickets, n_splits, lse, o32, s)
  if (dtype == 0) {
    switch (D) {
      case 16: REPRO_DECODE(float, 16);
      case 32: REPRO_DECODE(float, 32);
      case 64: REPRO_DECODE(float, 64);
      case 80: REPRO_DECODE(float, 80);
      case 128: REPRO_DECODE(float, 128);
      case 256: REPRO_DECODE(float, 256);
      default: return -2;
    }
  }
  if (dtype == 1) {
    switch (D) {
      case 16: REPRO_DECODE(bf16, 16);
      case 32: REPRO_DECODE(bf16, 32);
      case 64: REPRO_DECODE(bf16, 64);
      case 80: REPRO_DECODE(bf16, 80);
      case 128: REPRO_DECODE(bf16, 128);
      case 256: REPRO_DECODE(bf16, 256);
      default: return -2;
    }
  }
#undef REPRO_DECODE
  return -1;
}
