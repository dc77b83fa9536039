// Flash attention forward for Hopper (sm_90a), K1 of the port.
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` / `_flash_kernel`
// in src/repro/kernels/flash_attention.py, and computes what the model path
// needs beyond it: the model's (B, S, H, D) layout read through strides, a
// query offset read from device memory (decode against a KV cache, with no
// host sync), causal and sliding-window masks, and a ragged Skv.
//
// Semantics (those of repro.models.layers.flash_attention): scores q.k^T/sqrt(D)
// in f32, masked keys excluded, online softmax with a running max m, running
// sum l and an f32 accumulator; p is cast to v's dtype before the PV product;
// output acc / max(l, 1e-37) in q's dtype, so a row with no valid key is 0.
//
// What bounds it on an H100: decode (Sq = 1) reads the whole live KV cache
// once and does 2 flops per cached element, far below the card's ~295
// flops/byte bf16 balance point, so it is bound by the bytes of KV it reads.
// Causal prefill does 2 H D S(S+1) flops on 2 B S D (2H + 2Hkv) bytes:
// H (S+1) / (2H + 2Hkv) flops per byte, 171 for qwen3's 16/8 heads at
// S = 512 (just bytes-bound) and past the balance point from S ~ 885, where
// the tensor cores' bf16 rate bounds it.
//
// What the design does about it:
//  * GQA without copies: one block owns one kv head and the `group` query
//    heads that share it; its 64 rows are (query position, q head) pairs, so
//    every K/V tile is read from device memory once per group, not per head.
//  * The kv loop stops at the causal limit of the block's last query and
//    starts at the window's first key; rows past that are never loaded, so
//    decode reads only the pos + 1 live cache rows, not the S_max buffer.
//  * bf16 scores and PV products run on the tensor cores (WMMA 16x16x16,
//    f32 accumulate); f32 inputs take a plain FMA path (used for checks).
//  * Scores, softmax statistics and the accumulator stay in shared memory;
//    only q, k, v are read and the output written.
// Not yet done (later work): wgmma/TMA pipelining and a split-kv decode that
// spreads a long cache over more SMs than B * Hkv blocks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <math.h>
#include <type_traits>

namespace {

constexpr int BM = 64;       // rows per block: (query position, q head) pairs
constexpr int BN = 64;       // keys per kv tile
constexpr int NWARPS = 4;    // each warp owns BM / NWARPS = 16 rows
constexpr int NT = NWARPS * 32;
constexpr int ROWS_PER_WARP = BM / NWARPS;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory plan of one block.  Row pitches are padded by 16 bytes to
// spread banks; every region starts on a 128-byte boundary (WMMA needs 32).
template <typename T, int D>
struct Smem {
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LDT = D + PAD;        // q, k, v tiles (T)
  static constexpr int LDS = BN + 4;         // scores (f32)
  static constexpr int LDP = BN + PAD;       // probabilities (T)
  static constexpr int LDO = D + 4;          // accumulator (f32)
  static constexpr int Q = 0;
  static constexpr int K = round_up(Q + BM * LDT * (int)sizeof(T), 128);
  static constexpr int V = round_up(K + BN * LDT * (int)sizeof(T), 128);
  static constexpr int S = round_up(V + BN * LDT * (int)sizeof(T), 128);
  static constexpr int P = round_up(S + BM * LDS * 4, 128);
  static constexpr int O = round_up(P + BM * LDP * (int)sizeof(T), 128);
  static constexpr int M = round_up(O + BM * LDO * 4, 128);
  static constexpr int L = M + BM * 4;
  static constexpr int BYTES = L + BM * 4;
};

// S[r][c] = q_r . k_c for this warp's 16 rows and all BN keys (unscaled).
template <typename T, int D>
__device__ __forceinline__ void scores(const T* sQ, const T* sK, float* sS, int warp, int lane) {
  using SM = Smem<T, D>;
  const int r0 = warp * ROWS_PER_WARP;
  if constexpr (std::is_same<T, float>::value) {
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const float* qrow = sQ + (r0 + rr) * SM::LDT;
      for (int c = lane; c < BN; c += 32) {
        const float* krow = sK + c * SM::LDT;
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) acc = fmaf(qrow[d], krow[d], acc);
        sS[(r0 + rr) * SM::LDS + c] = acc;
      }
    }
  } else {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[D / 16];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wmma::load_matrix_sync(a[kk], sQ + r0 * SM::LDT + kk * 16, SM::LDT);
#pragma unroll
    for (int n = 0; n < BN / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // K^T as a column-major B operand: element (d, c) at sK[c * LDT + d].
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bk;
        wmma::load_matrix_sync(bk, sK + n * 16 * SM::LDT + kk * 16, SM::LDT);
        wmma::mma_sync(acc, a[kk], bk, acc);
      }
      wmma::store_matrix_sync(sS + r0 * SM::LDS + n * 16, acc, SM::LDS, wmma::mem_row_major);
    }
  }
}

// O[r][:] += P[r][:] . V for this warp's 16 rows.
template <typename T, int D>
__device__ __forceinline__ void accumulate_pv(const T* sP, const T* sV, float* sO, int warp,
                                              int lane) {
  using SM = Smem<T, D>;
  const int r0 = warp * ROWS_PER_WARP;
  if constexpr (std::is_same<T, float>::value) {
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const float* prow = sP + (r0 + rr) * SM::LDP;
      for (int d = lane; d < D; d += 32) {
        float acc = sO[(r0 + rr) * SM::LDO + d];
#pragma unroll 8
        for (int c = 0; c < BN; ++c) acc = fmaf(prow[c], sV[c * SM::LDT + d], acc);
        sO[(r0 + rr) * SM::LDO + d] = acc;
      }
    }
  } else {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[BN / 16];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wmma::load_matrix_sync(a[kk], sP + r0 * SM::LDP + kk * 16, SM::LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + r0 * SM::LDO + n * 16, SM::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, sV + kk * 16 * SM::LDT + n * 16, SM::LDT);
        wmma::mma_sync(acc, a[kk], bv, acc);
      }
      wmma::store_matrix_sync(sO + r0 * SM::LDO + n * 16, acc, SM::LDO, wmma::mem_row_major);
    }
  }
}

// Copy `nrows` rows of a (rows x D) tile into shared memory in 16-byte
// vectors, zero-filling rows [nrows, rows).  `row_ptr(r)` is row r's address.
template <typename T, int D, int ROWS, typename RowPtr>
__device__ __forceinline__ void load_tile(T* dst, int nrows, RowPtr row_ptr, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int DV = D / VEC;
  for (int i = tid; i < ROWS * DV; i += NT) {
    const int r = i / DV, c = (i % DV) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) val = *reinterpret_cast<const uint4*>(row_ptr(r) + c);
    *reinterpret_cast<uint4*>(dst + r * Smem<T, D>::LDT + c) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                 long long v_ss, long long v_sh, long long o_sb, long long o_ss,
                 long long o_sh, int Sq, int Skv, int group, int causal, int window,
                 const int* __restrict__ q_offset_dev, int q_offset, float scale) {
  using SM = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + SM::Q);
  T* sK = reinterpret_cast<T*>(smem + SM::K);
  T* sV = reinterpret_cast<T*>(smem + SM::V);
  float* sS = reinterpret_cast<float*>(smem + SM::S);
  T* sP = reinterpret_cast<T*>(smem + SM::P);
  float* sO = reinterpret_cast<float*>(smem + SM::O);
  float* sM = reinterpret_cast<float*>(smem + SM::M);
  float* sL = reinterpret_cast<float*>(smem + SM::L);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int positions = BM / group;             // query positions per block
  const int q0 = blockIdx.x * positions;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int nq = min(positions, Sq - q0);
  const int nrows = nq * group;                 // rows in use; the rest are padding
  const int off = q_offset + (q_offset_dev ? *q_offset_dev : 0);

  // Row r is query position q0 + r / group of q head hk * group + r % group.
  load_tile<T, D, BM>(sQ, nrows, [&](int r) {
    return q + b * q_sb + (long long)(q0 + r / group) * q_ss + (long long)(hk * group + r % group) * q_sh;
  }, tid);
  for (int r = tid; r < BM; r += NT) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }
  for (int i = tid; i < BM * D; i += NT) sO[(i / D) * SM::LDO + i % D] = 0.f;

  const int q_lo = off + q0, q_hi = off + q0 + nq - 1;  // absolute positions
  const int kv_end = causal ? min(Skv, q_hi + 1) : Skv;
  int kv_begin = window >= 0 ? max(0, q_lo - window + 1) : 0;
  kv_begin = kv_begin / BN * BN;

  for (int j0 = kv_begin; j0 < kv_end; j0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    const int nk = min(BN, kv_end - j0);
    load_tile<T, D, BN>(sK, nk, [&](int r) { return k + b * k_sb + (long long)(j0 + r) * k_ss + hk * k_sh; }, tid);
    load_tile<T, D, BN>(sV, nk, [&](int r) { return v + b * v_sb + (long long)(j0 + r) * v_ss + hk * v_sh; }, tid);
    __syncthreads();

    scores<T, D>(sQ, sK, sS, warp, lane);
    __syncwarp();

    // Online softmax over this warp's rows; lanes cover the BN keys.
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      const int pos = off + q0 + r / group;
      float s[BN / 32];
      bool ok[BN / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < BN / 32; ++t) {
        const int c = lane + 32 * t, kv = j0 + c;
        bool m = r < nrows && kv < kv_end;
        if (causal) m = m && kv <= pos;
        if (window >= 0) m = m && (pos - kv) < window;
        ok[t] = m;
        s[t] = m ? sS[r * SM::LDS + c] * scale : -INFINITY;
        mx = fmaxf(mx, s[t]);
      }
      mx = warp_max(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;  // fully masked row so far
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < BN / 32; ++t) {
        const float p = ok[t] ? expf(s[t] - m_safe) : 0.f;
        psum += p;
        sP[r * SM::LDP + lane + 32 * t] = from_f<T>(p);  // p in v's dtype for PV
      }
      psum = warp_sum(psum);
      const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_safe);
      for (int d = lane; d < D; d += 32) sO[r * SM::LDO + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + psum;
      }
    }
    __syncwarp();
    accumulate_pv<T, D>(sP, sV, sO, warp, lane);
  }
  __syncthreads();

  for (int i = tid; i < BM * D; i += NT) {
    const int r = i / D, d = i % D;
    if (r >= nrows) continue;
    const float out = sO[r * SM::LDO + d] / fmaxf(sL[r], 1e-37f);
    o[b * o_sb + (long long)(q0 + r / group) * o_ss + (long long)(hk * group + r % group) * o_sh + d] =
        from_f<T>(out);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const long long* st, int B,
           int Sq, int Skv, int H, int Hkv, int causal, int window, const int* q_offset_dev,
           int q_offset, float scale, cudaStream_t stream) {
  constexpr int bytes = Smem<T, D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int group = H / Hkv;
  const int positions = BM / group;
  dim3 grid((Sq + positions - 1) / positions, Hkv, B);
  flash_fwd_kernel<T, D><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], Sq, Skv, group, causal, window, q_offset_dev, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o, const long long* st,
               int B, int Sq, int Skv, int H, int Hkv, int causal, int window,
               const int* q_offset_dev, int q_offset, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, st, B, Sq, Skv, H, Hkv, causal, window, q_offset_dev, q_offset, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, st, B, Sq, Skv, H, Hkv, causal, window, q_offset_dev, q_offset, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, st, B, Sq, Skv, H, Hkv, causal, window, q_offset_dev, q_offset, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, st, B, Sq, Skv, H, Hkv, causal, window, q_offset_dev, q_offset, scale, stream);
    default: return -2;
  }
}

}  // namespace

// C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// strides: 12 element strides (batch, seq, head) of q, k, v, o; the head
// dimension must be contiguous and every row 16-byte aligned (the Python
// wrapper checks).  window < 0 disables the window.  The query offset is
// q_offset plus *q_offset_dev when that pointer is not null.
// Returns 0, a cudaError_t, or -1 / -2 for an unsupported dtype / head dim.
extern "C" int repro_flash_attention_fwd(int dtype, int D, const void* q, const void* k,
                                         const void* v, void* o, const long long* strides,
                                         int B, int Sq, int Skv, int H, int Hkv, int causal,
                                         int window, const int* q_offset_dev, int q_offset,
                                         float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, strides, B, Sq, Skv, H, Hkv, causal, window,
                             q_offset_dev, q_offset, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, strides, B, Sq, Skv, H, Hkv, causal, window,
                                     q_offset_dev, q_offset, scale, s);
  return -1;
}
