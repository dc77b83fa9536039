// The backward of the fused selective scan (the Mamba1 core) for Hopper
// (sm_90a): K2's backward in the port.
//
// The reference has no kernel for it: JAX differentiates the fused jnp
// core `_mamba1_core_fused` in src/repro/models/ssm.py (the Pallas kernel
// `ssm_scan_kernel` in src/repro/kernels/ssm_scan.py is forward only).
// Forward, per (b, d, n), from h_{-1} = 0:
//     decay_t = exp(dt_t A),  inc_t = (dt_t x_t) B_t
//     h_t = decay_t h_{t-1} + inc_t,  y_t[d] = sum_n h_t[d, n] C_t[n]
// Backward, from dy (B, S, d) f32, with g_t = dL/dh_t:
//     g_t = dy_t C_t + decay_{t+1} g_{t+1}
//     d decay_t = g_t h_{t-1};  d inc_t = g_t
//     ddt_t = sum_n (d decay_t decay_t A + g_t x_t B_t)
//     dx_t  = sum_n g_t dt_t B_t
//     dB_t[n] = sum_d g_t dt_t x_t;   dC_t[n] = sum_d dy_t h_t
//     dA[d, n] = sum_{b, t} d decay_t decay_t dt_t
// Inputs: x, dt (B, S, d) and B, C (B, S, N, rows `bstride` / `cstride`
// apart), all float32 or all bfloat16; A (d, N), dy (B, S, d) and the
// forward's states (B, ceil(S / T), d, N) float32: the state before steps
// 0, T, 2T, ...  Outputs float32: dx, ddt (B, S, d), dB, dC (B, S, N),
// dA (d, N).
//
// What bounds it on an H100: the B S d N exponentials (decay recomputed
// once) on the SFUs, about as much as its bytes (x, dt, dy and the states
// read, dx and ddt written).
//
// What the design does about it:
//  * One thread per state element (b, d, n) walks the sequence backward a
//    segment of T = 16 steps at a time.  It loads the segment's inputs
//    (every load issued before the first is used, so that their latencies
//    overlap), recomputes the segment forward from the stored state,
//    keeping h_{t-1} and decay_t of each step in registers (the loops are
//    unrolled), then walks it backward with g in a register; g crosses
//    into the next segment down through shared memory.  One exponential a
//    state element and step.
//  * The walk writes each step's terms of ddt, dx, dB and dC to shared
//    memory and sums nothing on the way: shuffle sums at every step would
//    put their latency on every step.  After the segment the block sums
//    them: ddt and dx over each channel's n, dB and dC over the pass's
//    channels, each in a fixed order; dx and ddt go out as whole rows of
//    channels.
//  * dB, dC and dA reduce across channels, over many blocks.  No float
//    atomics, so two calls give the same bits: a block owns a slab of
//    `npass` x NTB / P channels and walks them pass after pass, segment by
//    segment, summing the passes in shared memory and writing one partial
//    per slab (partials (2, slabs, B, S, N)); dA per (b, d, n) stays in
//    shared memory over the whole walk (partials (B, d, N)).  A second
//    kernel sums the partials over slabs and over b in a fixed order.
//    `npass` is chosen by the wrapper so that the grid is about one wave
//    of the card and the partials stay small (64 slabs at d = 8192,
//    N = 16).
//  * Products are rounded as written (no fused multiply-add in the
//    recomputed recurrence), so the recomputed states equal the forward's.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NTB = 256;  // threads a block: NTB / P channels a pass
constexpr int T = 16;     // steps between stored states (the forward's STATE_EVERY)
constexpr int RED = 256;  // threads a block of the reduction

// Shared memory of a block: the carried g and dA's sums ([npass][NTB] each),
// the slab's dB and dC sums of a segment ([2][T][P]), and a pass's terms of
// ddt, dx, dB and dC ([4][T][NTB / P][P + 1]: a channel's P lanes in a row,
// padded so that reading a row or a column is free of bank conflicts).
__host__ __device__ constexpr int smem_floats(int P, int npass) {
  return 2 * NTB * npass + 2 * T * P + 4 * T * (NTB / P) * (P + 1);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename Tin, int P>
__global__ void __launch_bounds__(NTB, 2)
ssm_scan_bwd_kernel(const Tin* __restrict__ x, const Tin* __restrict__ dt,
                    const Tin* __restrict__ Bm, long long bstride, const Tin* __restrict__ Cm,
                    long long cstride, const float* __restrict__ A,
                    const float* __restrict__ dy, const float* __restrict__ states,
                    float* __restrict__ dx, float* __restrict__ ddt,
                    float* __restrict__ part_bc, float* __restrict__ part_a, int nbatch, int S,
                    int d, int N, int npass) {
  extern __shared__ float smem[];
  constexpr int CH = NTB / P;       // channels a pass
  constexpr int ROW = P + 1;        // a channel's row of terms, padded
  constexpr int QS = T * CH * ROW;  // one quantity's terms
  const int slots = NTB * npass;
  float* gcar = smem;          // [npass][NTB]: g carried into the segment below
  float* dacc = gcar + slots;  // [npass][NTB]: dA summed over the steps
  float* sacc = dacc + slots;  // [2][T][P]: the slab's dB and dC sums of a segment
  float* terms = sacc + 2 * T * P;  // [4][T][CH][ROW]: ddt, dx, dB, dC terms
  const int tid = threadIdx.x;
  const int n = tid % P, cw = tid / P;
  const long long b = blockIdx.y;
  const int slab = blockIdx.x;
  const int K = (S + T - 1) / T;
  const long long row = b * S;  // (b, 0) as a row index of (B, S, .)

  for (int i = tid; i < 2 * slots; i += NTB) smem[i] = 0.f;  // each thread its own slots

  for (int k = K - 1; k >= 0; --k) {
    const int t0 = k * T;
    const int len = min(T, S - t0);
    for (int i = tid; i < 2 * T * P; i += NTB) sacc[i] = 0.f;
    for (int pass = 0; pass < npass; ++pass) {
      const int ch = (slab * npass + pass) * CH + cw;
      const bool live = ch < d && n < N;  // dead lanes' terms are 0
      const int c = live ? ch : 0, nn = live ? n : 0;
      const Tin* xp = x + row * d + c;
      const Tin* tp = dt + row * d + c;
      const Tin* bp = Bm + row * bstride + nn;
      const Tin* cp = Cm + row * cstride + nn;
      const float* yp = dy + row * d + c;
      const float a = A[(long long)c * N + nn];

      // the segment's inputs, all loads issued before any is used, then
      // the segment forward from its stored state: h_{t-1} and decay_t
      float h = live ? states[((b * K + k) * d + c) * N + nn] : 0.f;
      Tin xs[T], ts[T], bs[T], cs[T];
      float ys[T], hp[T], dc[T];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const bool ok = live && i < len;
        const long long t = t0 + i;
        xs[i] = ok ? xp[t * d] : Tin(0.f);
        ts[i] = ok ? tp[t * d] : Tin(0.f);
        bs[i] = ok ? bp[t * bstride] : Tin(0.f);
        cs[i] = ok ? cp[t * cstride] : Tin(0.f);
        ys[i] = ok ? yp[t * d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const float tv = to_f(ts[i]);
        const float dec = expf(__fmul_rn(tv, a));  // 1 past S: h passes unchanged
        const float inc = __fmul_rn(__fmul_rn(tv, to_f(xs[i])), to_f(bs[i]));
        hp[i] = h;
        dc[i] = dec;
        h = __fadd_rn(__fmul_rn(dec, h), inc);
      }

      // ... and backward (no branch on the step: steps past S are masked)
      float carry = gcar[pass * NTB + tid];  // decay_{t+1} g_{t+1}
      float da = 0.f;
      float ht = h;  // h_t of the step walked: the segment's last state first
#pragma unroll
      for (int i = T - 1; i >= 0; --i) {
        const bool in = i < len;  // the same for every thread of the block
        const bool ok = live && in;
        const float yv = ys[i], cv = to_f(cs[i]), xv = to_f(xs[i]);
        const float tv = to_f(ts[i]), bv = to_f(bs[i]);
        const float g = ok ? __fadd_rn(__fmul_rn(yv, cv), carry) : 0.f;
        const float dd = __fmul_rn(__fmul_rn(g, hp[i]), dc[i]);  // dL/d(dt A)
        da = __fadd_rn(da, __fmul_rn(dd, tv));
        float* out = terms + (i * CH + cw) * ROW + n;  // steps past S: never read
        out[0] = __fadd_rn(__fmul_rn(dd, a), __fmul_rn(__fmul_rn(g, xv), bv));  // ddt
        out[QS] = __fmul_rn(__fmul_rn(g, tv), bv);                               // dx
        out[2 * QS] = __fmul_rn(__fmul_rn(g, tv), xv);                           // dB
        out[3 * QS] = __fmul_rn(yv, ht);                                         // dC
        if (in) {
          carry = __fmul_rn(dc[i], g);
          ht = hp[i];
        }
      }
      gcar[pass * NTB + tid] = carry;
      dacc[pass * NTB + tid] += da;
      __syncthreads();
      // ddt and dx: each (step, channel) summed over its lanes, in order
      const int ch0 = (slab * npass + pass) * CH;
      for (int e = tid; e < len * CH; e += NTB) {
        const int i = e / CH, c2 = e % CH;
        const float* r = terms + (i * CH + c2) * ROW;
        float st = 0.f, sx = 0.f;
#pragma unroll
        for (int m = 0; m < P; ++m) {
          st += r[m];
          sx += r[QS + m];
        }
        if (ch0 + c2 < d) {
          ddt[(row + t0 + i) * d + ch0 + c2] = st;
          dx[(row + t0 + i) * d + ch0 + c2] = sx;
        }
      }
      // dB and dC: each (step, lane) summed over the pass's channels, in order
      for (int e = tid; e < len * P; e += NTB) {
        const int i = e / P, m = e % P;
        const float* r = terms + 2 * QS + i * CH * ROW + m;
        float sb = 0.f, sc = 0.f;
        for (int c2 = 0; c2 < CH; ++c2) {
          sb += r[c2 * ROW];
          sc += r[QS + c2 * ROW];
        }
        sacc[i * P + m] += sb;
        sacc[(T + i) * P + m] += sc;
      }
      __syncthreads();
    }
    for (int e = tid; e < 2 * len * P; e += NTB) {
      const int q = e / (len * P), r = e % (len * P), i = r / P, m = r % P;
      if (m < N)
        part_bc[(((long long)q * gridDim.x + slab) * nbatch * S + row + t0 + i) * N + m] =
            sacc[(q * T + i) * P + m];
    }
    __syncthreads();  // before the next segment clears sacc
  }
  for (int pass = 0; pass < npass; ++pass) {
    const int ch = (slab * npass + pass) * CH + cw;
    if (ch < d && n < N) part_a[(b * d + ch) * N + n] = dacc[pass * NTB + tid];
  }
}

// out[i] = sum over s < ns, in order, of in[s * stride + i], for i < count.
__global__ void __launch_bounds__(RED)
ssm_scan_bwd_reduce_kernel(const float* __restrict__ in, float* __restrict__ out, int ns,
                           long long stride, long long count) {
  const long long i = (long long)blockIdx.x * RED + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int k = 0; k < ns; ++k) s += in[k * stride + i];
  out[i] = s;
}

int reduce(const float* in, float* out, int ns, long long count, cudaStream_t stream) {
  if (count == 0) return 0;
  const long long blocks = (count + RED - 1) / RED;
  ssm_scan_bwd_reduce_kernel<<<(unsigned)blocks, RED, 0, stream>>>(in, out, ns, count, count);
  return (int)cudaGetLastError();
}

// The instantiation of the backward kernel for the lanes P of a channel.
template <typename Tin>
auto pick_kernel(int P) {
  return P == 1    ? ssm_scan_bwd_kernel<Tin, 1>
         : P == 2  ? ssm_scan_bwd_kernel<Tin, 2>
         : P == 4  ? ssm_scan_bwd_kernel<Tin, 4>
         : P == 8  ? ssm_scan_bwd_kernel<Tin, 8>
         : P == 16 ? ssm_scan_bwd_kernel<Tin, 16>
                   : ssm_scan_bwd_kernel<Tin, 32>;
}

template <typename Tin>
int launch(const void* x, const void* dt, const void* Bm, long long bstride, const void* Cm,
           long long cstride, const float* A, const float* dy, const float* states, float* dx,
           float* ddt, float* dB, float* dC, float* dA, float* part_bc, float* part_a, int B,
           int S, int d, int N, int npass, int nslab, cudaStream_t stream) {
  int P = 1;
  while (P < N) P <<= 1;
  const int CH = NTB / P;
  const int chunks = (d + CH - 1) / CH;
  if (npass < 1 || nslab != (chunks + npass - 1) / npass) return -3;
  const size_t smem = sizeof(float) * smem_floats(P, npass);
  const auto kernel = pick_kernel<Tin>(P);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nslab, B);
  kernel<<<grid, NTB, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(dt), static_cast<const Tin*>(Bm),
      bstride, static_cast<const Tin*>(Cm), cstride, A, dy, states, dx, ddt, part_bc, part_a,
      B, S, d, N, npass);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long bsn = (long long)B * S * N;
  if ((err = reduce(part_bc, dB, nslab, bsn, stream)) != 0) return err;
  if ((err = reduce(part_bc + (long long)nslab * bsn, dC, nslab, bsn, stream)) != 0) return err;
  return reduce(part_a, dA, B, (long long)d * N, stream);
}

}  // namespace

// C interface, loaded with ctypes.  dtype (of x, dt, B and C alike): 0 =
// float32, 1 = bfloat16.  x, dt, dy contiguous (B, S, d); B and C (B, S, N)
// with unit element stride and rows bstride / cstride elements apart; A
// contiguous (d, N); states contiguous (B, ceil(S / 16), d, N); the
// outputs contiguous float32: dx, ddt (B, S, d), dB, dC (B, S, N), dA
// (d, N); scratch part_bc (2, nslab, B, S, N) and part_a (B, d, N).
// `npass` and `nslab` are the wrapper's plan (nslab = ceil(ceil(d / (256 /
// P)) / npass), P the power of two at least N).  Returns 0, a cudaError_t,
// or -1 / -2 / -3 for an unsupported dtype / state size / plan.
extern "C" int repro_ssm_scan_bwd(int dtype, const void* x, const void* dt, const void* Bm,
                                  long long bstride, const void* Cm, long long cstride,
                                  const void* A, const void* dy, const void* states, void* dx,
                                  void* ddt, void* dB, void* dC, void* dA, void* part_bc,
                                  void* part_a, int B, int S, int d, int N, int npass,
                                  int nslab, void* stream) {
  if (N < 1 || N > 32) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* g = static_cast<const float*>(dy);
  const float* st = static_cast<const float*>(states);
  float *o1 = static_cast<float*>(dx), *o2 = static_cast<float*>(ddt);
  float *o3 = static_cast<float*>(dB), *o4 = static_cast<float*>(dC);
  float* o5 = static_cast<float*>(dA);
  float *p1 = static_cast<float*>(part_bc), *p2 = static_cast<float*>(part_a);
  if (dtype == 0)
    return launch<float>(x, dt, Bm, bstride, Cm, cstride, a, g, st, o1, o2, o3, o4, o5, p1, p2,
                         B, S, d, N, npass, nslab, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, Bm, bstride, Cm, cstride, a, g, st, o1, o2, o3, o4, o5,
                                 p1, p2, B, S, d, N, npass, nslab, s);
  return -1;
}

// The steps between the states the backward reads, for the wrapper to
// check against the forward's.
extern "C" int repro_ssm_scan_bwd_state_every() { return T; }
