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
//    The buffer holds the loaded values as they are (bf16 or f32) and
//    converts them where they are used: a conversion next to the load
//    would wait for it and undo the prefetch.
//  * C_t is the same for every channel of a batch row: all the block's
//    lanes with the same n read one address, which a warp's load
//    broadcasts and the SM's L1 cache serves to the block's other warps.
//  * h is rounded after the multiply and after the add (no fused
//    multiply-add), as the plain version's two elementwise operations round
//    it, so the kernel's states equal the plain version's bit for bit and
//    only the order of the sum over n differs.
//
// The fused form (repro_ssm_scan_fused_fwd, `ssm_scan_fused_kernel`) is the
// reference's default Mamba1 core, `_mamba1_core_fused` in
// src/repro/models/ssm.py: x and dt (B, S, d), B and C (B, S, N) and
// A (d, N) go in, and each thread builds its own decay = exp(dt A) and
// inc = (dt x) B in registers, with the operation order of the port's
// `decay_inc` (the product dt A rounded, then an accurate expf; dt x
// rounded, then times B), so the two (B, S, d, N) f32 tensors never reach
// device memory.  B and C are read with a row stride, so the strided
// slices of the model's x_proj output go in without a copy.  What bounds
// it then: the B S d N exponentials on the SFUs (16 a clock an SM), more
// than its bytes (x, dt read once, y written once).  The recurrence, the
// shuffle sum and the loads ahead are the same code as the unfused
// kernel's: one body, templated over how a step's inputs are loaded.
// With a `states` buffer it also writes h every STATE_EVERY steps (the
// state before steps 0, T, 2T, ...; (B, ceil(S / T), d, N) f32), from
// which the backward (ssm_scan_bwd.cu) recomputes a segment; without one
// (serving) it writes nothing more than y.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads per block: NT / P channels
constexpr int U = 8;             // time steps loaded ahead of the recurrence
constexpr int STATE_EVERY = 16;  // steps between stored states (a multiple of U)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// The unfused kernel's inputs: decay, inc (B, S, d, N) and C (B, S, N).
template <typename T>
struct PlainLoader {
  const T* decay;
  const T* inc;
  const T* C;
  const T *dp, *ip, *cp;
  long long dstep;
  int N;
  struct Raw { T dc, ic, c; };

  __device__ void start(long long b, int ch, int n, int S, int d, int N_) {
    N = N_;
    dstep = (long long)d * N;
    const long long base = (b * S * d + ch) * N + n;
    dp = decay + base;
    ip = inc + base;
    cp = C + b * S * N + n;
  }
  __device__ Raw load(int t, bool ok) const {
    Raw r;
    r.dc = ok ? dp[t * dstep] : T(0.f);
    r.ic = ok ? ip[t * dstep] : T(0.f);
    r.c = ok ? cp[(long long)t * N] : T(0.f);
    return r;
  }
  __device__ void expand(const Raw& r, float& dc, float& ic, float& c) const {
    dc = to_f(r.dc);
    ic = to_f(r.ic);
    c = to_f(r.c);
  }
};

// The fused kernel's inputs: x, dt (B, S, d), B, C (B, S, N) with row
// strides, A (d, N) f32.
template <typename T>
struct FusedLoader {
  const T* x;
  const T* dt;
  const T* Bm;
  long long bstride;
  const T* Cm;
  long long cstride;
  const float* A;
  const T *xp, *tp, *bp, *cp;
  long long d;
  float a;
  struct Raw { T x, dt, b, c; };

  __device__ void start(long long b, int ch, int n, int S, int d_, int N) {
    d = d_;
    xp = x + b * S * d + ch;
    tp = dt + b * S * d + ch;
    bp = Bm + b * S * bstride + n;
    cp = Cm + b * S * cstride + n;
    a = A[(long long)ch * N + n];
  }
  __device__ Raw load(int t, bool ok) const {
    Raw r;
    r.x = ok ? xp[t * d] : T(0.f);
    r.dt = ok ? tp[t * d] : T(0.f);
    r.b = ok ? bp[t * bstride] : T(0.f);
    r.c = ok ? cp[t * cstride] : T(0.f);
    return r;
  }
  __device__ void expand(const Raw& r, float& dc, float& ic, float& c) const {
    const float dt = to_f(r.dt);
    dc = expf(__fmul_rn(dt, a));
    ic = __fmul_rn(__fmul_rn(dt, to_f(r.x)), to_f(r.b));
    c = to_f(r.c);
  }
};

// One thread per state element (b, ch, n) for the whole sequence: the
// recurrence, y_t by a shuffle sum over the channel's P lanes, and (with
// `states`) h before every STATE_EVERY-th step.  P is a template argument
// so that the shuffle sums unroll and the U steps' sums overlap.
template <int P, class Loader>
__device__ __forceinline__ void scan_body(Loader ld, float* __restrict__ y,
                                          float* __restrict__ states, int S, int d, int N) {
  const int n = threadIdx.x % P;  // P divides 32, so a channel never spans two warps
  const int ch = blockIdx.x * (NT / P) + threadIdx.x / P;
  const long long b = blockIdx.y;
  const bool live = ch < d && n < N;  // dead lanes still join the shuffles
  ld.start(b, live ? ch : 0, live ? n : 0, S, d, N);
  float* yp = y + b * S * d + (live ? ch : 0);
  const long long K = (S + STATE_EVERY - 1) / STATE_EVERY;
  float* sp = (states != nullptr && live) ? states + ((b * K) * d + ch) * N + n : nullptr;

  typename Loader::Raw cur[U], nxt[U];  // steps t0 .. t0 + U - 1, and the next U in flight
#pragma unroll
  for (int u = 0; u < U; ++u) cur[u] = ld.load(u, live && u < S);

  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) nxt[u] = ld.load(t0 + U + u, live && t0 + U + u < S);
    if (sp != nullptr && t0 % STATE_EVERY == 0)
      sp[(long long)(t0 / STATE_EVERY) * d * N] = h;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dc, ic, c;
      ld.expand(cur[u], dc, ic, c);
      h = __fadd_rn(__fmul_rn(dc, h), ic);
      float v = h * c;
#pragma unroll
      for (int o = P >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const int t = t0 + u;
      if (live && n == 0 && t < S) yp[(long long)t * d] = v;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = nxt[u];
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(NT)
ssm_scan_kernel(const T* __restrict__ decay, const T* __restrict__ inc,
                const T* __restrict__ C, float* __restrict__ y, int S, int d, int N) {
  PlainLoader<T> ld;
  ld.decay = decay;
  ld.inc = inc;
  ld.C = C;
  scan_body<P>(ld, y, nullptr, S, d, N);
}

template <typename T, int P>
__global__ void __launch_bounds__(NT)
ssm_scan_fused_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const T* __restrict__ Bm, long long bstride, const T* __restrict__ Cm,
                      long long cstride, const float* __restrict__ A, float* __restrict__ y,
                      float* __restrict__ states, int S, int d, int N) {
  FusedLoader<T> ld;
  ld.x = x;
  ld.dt = dt;
  ld.Bm = Bm;
  ld.bstride = bstride;
  ld.Cm = Cm;
  ld.cstride = cstride;
  ld.A = A;
  scan_body<P>(ld, y, states, S, d, N);
}

int pow2_at_least(int N) {
  int P = 1;
  while (P < N) P <<= 1;
  return P;
}

// The instantiation of `kernel` for the lanes P of a channel (1 to 32).
#define PICK_P(kernel, T, P)                                                          \
  ((P) == 1    ? kernel<T, 1>                                                         \
   : (P) == 2  ? kernel<T, 2>                                                         \
   : (P) == 4  ? kernel<T, 4>                                                         \
   : (P) == 8  ? kernel<T, 8>                                                         \
   : (P) == 16 ? kernel<T, 16>                                                        \
               : kernel<T, 32>)

template <typename T>
int launch(const void* decay, const void* inc, const void* C, float* y, int B, int S, int d,
           int N, cudaStream_t stream) {
  const int P = pow2_at_least(N);
  const int per_block = NT / P;
  dim3 grid((d + per_block - 1) / per_block, B);
  const auto kernel = PICK_P(ssm_scan_kernel, T, P);
  kernel<<<grid, NT, 0, stream>>>(
      static_cast<const T*>(decay), static_cast<const T*>(inc), static_cast<const T*>(C), y, S,
      d, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fused(const void* x, const void* dt, const void* Bm, long long bstride,
                 const void* Cm, long long cstride, const float* A, float* y, float* states,
                 int B, int S, int d, int N, cudaStream_t stream) {
  const int P = pow2_at_least(N);
  const int per_block = NT / P;
  dim3 grid((d + per_block - 1) / per_block, B);
  const auto kernel = PICK_P(ssm_scan_fused_kernel, T, P);
  kernel<<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const T*>(Bm), bstride,
      static_cast<const T*>(Cm), cstride, A, y, states, S, d, N);
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

// The fused form.  dtype (of x, dt, B and C alike) as above; x and dt
// contiguous (B, S, d); B and C (B, S, N) with unit element stride and
// rows `bstride` / `cstride` elements apart; A a contiguous (d, N) float32;
// y a contiguous (B, S, d) float32 buffer; `states` null, or a contiguous
// (B, ceil(S / STATE_EVERY), d, N) float32 buffer to receive the state
// before every STATE_EVERY-th step.  Returns as repro_ssm_scan_fwd does.
extern "C" int repro_ssm_scan_fused_fwd(int dtype, const void* x, const void* dt, const void* Bm,
                                        long long bstride, const void* Cm, long long cstride,
                                        const void* A, void* y, void* states, int B, int S,
                                        int d, int N, void* stream) {
  if (N < 1 || N > 32) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  float* out = static_cast<float*>(y);
  float* st = static_cast<float*>(states);
  if (dtype == 0)
    return launch_fused<float>(x, dt, Bm, bstride, Cm, cstride, a, out, st, B, S, d, N, s);
  if (dtype == 1)
    return launch_fused<__nv_bfloat16>(x, dt, Bm, bstride, Cm, cstride, a, out, st, B, S, d, N,
                                       s);
  return -1;
}

// The steps between the stored states, for the wrapper to check against
// its own constant.
extern "C" int repro_ssm_scan_state_every() { return STATE_EVERY; }
