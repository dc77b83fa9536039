// Selective scan (the diagonal SSM recurrence) for Hopper (sm_90a), K2 of
// the port.
//
// Replaces the Pallas TPU kernel `ssm_scan_kernel` / `_ssm_kernel` in
// src/repro/kernels/ssm_scan.py, and computes its function:
//     h_t = decay_t * h_{t-1} + inc_t        per (b, d, n), h_0 = 0, in f32
//     y_t[b, d] = sum_n h_t[b, d, n] * C_t[b, n]
// decay, inc: (B, S, d, N); C: (B, S, N); all three contiguous, float32 or
// bfloat16, read as f32.  y: (B, S, d) float32.  Any S, any d, 1 <= N <= 32,
// no padding and no chunk or block size to divide them.
//
// What bounds it on an H100: bytes.  Each element of decay and inc is read
// once for one multiply and one add, so a call moves 4 (2BSdN + BSN + BSd)
// bytes (f32) for about 4 BSdN flops: half a flop per byte, far below the
// card's f32 balance point of some 20 flops per byte.  At Mamba1's prefill
// shape B=4, S=512, d=8192, N=16 that is 2.21 GB, 0.661 ms at 3.35 TB/s.
//
// What the design does about it:
//  * The TPU kernel carries h in VMEM across a sequential chunk grid axis.
//    Blocks on Hopper run in no order, so each thread owns one state element
//    (b, d, n) for the whole sequence and loops over t with h in a register;
//    nothing is carried between blocks, and the state never reaches memory.
//  * A channel's N states sit on P = next_pow2(N) neighbouring lanes of one
//    warp (lanes with n >= N hold 0); y_t is a __shfl_xor_sync sum over
//    those P lanes.  A warp covers 32 / P channels, so for N = P its loads
//    of decay_t and inc_t are 32 neighbouring elements: 128 coalesced bytes.
//  * The only dependency from step to step is h.  The loads of the next U
//    steps are issued before the current U steps are computed (a register
//    double buffer), so every thread keeps 2U loads in flight under the
//    recurrence, enough to cover device-memory latency at full occupancy.
//  * C_t is the same for every channel of a batch row: all the block's
//    lanes with the same n read one address, which a warp's load
//    broadcasts and the SM's L1 cache serves to the block's other warps.
//  * h is rounded after the multiply and after the add (no fused
//    multiply-add), as the plain version's two elementwise operations round
//    it, so the kernel's states equal the plain version's bit for bit and
//    only the order of the sum over n differs.
// Not yet done (later work): building decay = exp(dt A) and inc = dt x B
// inside the kernel, as the reference's fused Mamba1 core does, so that the
// two (B, S, d, N) f32 tensors never reach device memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per block: NT / P channels
constexpr int U = 8;     // time steps loaded ahead of the recurrence

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(NT)
ssm_scan_kernel(const T* __restrict__ decay, const T* __restrict__ inc,
                const T* __restrict__ C, float* __restrict__ y, int S, int d, int N, int P) {
  const int n = threadIdx.x % P;  // P divides 32, so a channel never spans two warps
  const int ch = blockIdx.x * (NT / P) + threadIdx.x / P;
  const long long b = blockIdx.y;
  const bool live = ch < d && n < N;  // dead lanes still join the shuffles
  const long long dstep = (long long)d * N;  // elements from step t to t + 1
  const long long base = (b * S * d + (live ? ch : 0)) * N + (live ? n : 0);
  const T* dp = decay + base;
  const T* ip = inc + base;
  const T* cp = C + b * S * N + (live ? n : 0);
  float* yp = y + b * S * d + (live ? ch : 0);

  float dc[U], ic[U], cc[U];  // steps t0 .. t0 + U - 1
  float dn[U], in[U], cn[U];  // the next U steps, in flight
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool ok = live && u < S;
    dc[u] = ok ? to_f(dp[u * dstep]) : 0.f;
    ic[u] = ok ? to_f(ip[u * dstep]) : 0.f;
    cc[u] = ok ? to_f(cp[(long long)u * N]) : 0.f;
  }

  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + U + u;
      const bool ok = live && t < S;
      dn[u] = ok ? to_f(dp[t * dstep]) : 0.f;
      in[u] = ok ? to_f(ip[t * dstep]) : 0.f;
      cn[u] = ok ? to_f(cp[(long long)t * N]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = __fadd_rn(__fmul_rn(dc[u], h), ic[u]);
      float v = h * cc[u];
      for (int o = P >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const int t = t0 + u;
      if (live && n == 0 && t < S) yp[(long long)t * d] = v;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      dc[u] = dn[u];
      ic[u] = in[u];
      cc[u] = cn[u];
    }
  }
}

template <typename T>
int launch(const void* decay, const void* inc, const void* C, float* y, int B, int S, int d,
           int N, cudaStream_t stream) {
  int P = 1;
  while (P < N) P <<= 1;
  const int per_block = NT / P;
  dim3 grid((d + per_block - 1) / per_block, B);
  ssm_scan_kernel<T><<<grid, NT, 0, stream>>>(static_cast<const T*>(decay),
                                              static_cast<const T*>(inc),
                                              static_cast<const T*>(C), y, S, d, N, P);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  dtype (of decay, inc and C alike):
// 0 = float32, 1 = bfloat16.  All inputs contiguous (the Python wrapper
// checks), y a contiguous (B, S, d) float32 buffer.  Returns 0, a
// cudaError_t, or -1 / -2 for an unsupported dtype / state size N.
extern "C" int repro_ssm_scan_fwd(int dtype, const void* decay, const void* inc, const void* C,
                                  void* y, int B, int S, int d, int N, void* stream) {
  if (N < 1 || N > 32) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(y);
  if (dtype == 0) return launch<float>(decay, inc, C, out, B, S, d, N, s);
  if (dtype == 1) return launch<__nv_bfloat16>(decay, inc, C, out, B, S, d, N, s);
  return -1;
}
