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
// 0, T, 2T, ...  Outputs: dx, ddt (B, S, d) in the inputs' dtype, each the
// f32 sum rounded once; dB, dC (B, S, N) and dA (d, N) float32.
//
// What bounds it on an H100: its bytes (x, dt, dy and the states read,
// dx and ddt written) and the B S d N exponentials (decay recomputed once)
// on the SFUs, about equally; beside them some 35 instructions a state and
// step (the accurate expf, the recurrence, the gradient's products, the
// shuffles that sum dB and dC) on the issue slots.
//
// What the design does about it:
//  * L lanes a channel, each with NL = P / L of its P = next_pow2(N)
//    states in registers, L chosen by P alone: one lane at P <= 4, two
//    lanes of 4 at P = 8, four lanes of 4 at P = 16 and of 8 at P = 32
//    (forms with fewer states on more lanes spilled under ptxas).
//    A block walks the sequence backward a segment of T = 16 steps at a
//    time: it recomputes the segment forward from the stored state,
//    keeping h_{t-1} and decay_t of each step in registers (the loops are
//    unrolled; at NL = 8 the segment is walked in four quarters of 4
//    steps, each recomputed from the stored state: 2.5 exponentials a
//    state and step), then walks it backward with g in registers.  The
//    channel's sums over n stay in the thread: ddt and dx (plus log2 L
//    shuffles), written in their final dtype, rounded once.
//  * The inputs are staged in shared memory a segment ahead, through a
//    ring of STAGES stages: the x, dt and dy rows of the block's channels,
//    the B and C rows of the segment, and the segment's states.  One
//    thread refills a stage by TMA (tensor maps for the rows, a bulk copy
//    for the states; completion on the stage's mbarrier) once the block is
//    done with it.  Where the wrapper finds the rows not 16-byte aligned it
//    asks for the threads' load path instead: the block's threads copy the
//    same tiles.  Past S, d and N the tiles hold zeros: dt = dy = 0 gives
//    decay 1, inc 0 and g 0 there, so no step needs a mask.
//  * dB and dC sum over channels in a fixed order, with no atomics, so two
//    calls give the same bits.  Each step, a warp reduce-scatters its
//    lanes' 2 NL terms across its channels by recursive halving (2 NL - 1
//    shuffles a lane where the warp has 2 NL channels, as at L = 4, NL =
//    4), and the block's warps write their sums to shared memory; after
//    the segment the block adds the warps' sums in order and writes one
//    partial per block (partials (2, blocks along d, B, S, N)).
//    A block may walk `npass` groups of NTB / L channels (the wrapper's
//    plan), the passes' sums added in order, so that the partials stay
//    small.  dA stays in registers over a segment and in shared memory
//    between segments (partials (B, d, N)).  A second kernel sums the
//    partials over blocks and over b in a fixed order.
//  * Products are rounded as written (no fused multiply-add in the
//    recomputed recurrence), so the recomputed states equal the forward's.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "tma.cuh"

namespace {

using namespace hopper;

constexpr int NTB = 128;       // threads a block: NTB / L channels a pass
constexpr int NW = NTB / 32;   // warps a block
constexpr int T = 16;          // steps between stored states (the forward's STATE_EVERY)
constexpr int STAGES = 3;      // segments in the ring
constexpr int RED = 256;       // threads a block of the reduction

struct BwdArgs {
  const void *x, *dt, *Bm, *Cm;
  long long bstride, cstride;
  const float *A, *dy, *states;
  void *dx, *ddt;
  float *part_bc, *part_a;
  int B, S, d, N, npass, tma;
};
struct BwdMaps {
  CUtensorMap x, dt, dy, B, C;  // unused on the threads' load path
};

// Shared memory of a block, in bytes: STAGES stages of x, dt [T][CHB]
// (inputs' dtype), dy [T][CHB] f32, B, C [T][P] and the states [CHB][N]
// f32; the warps' dB and dC sums of two segments [2][T][NW][2P]; the
// carried g and dA's sums [2][npass][NL][NTB]; the ring's mbarriers.
__host__ __device__ constexpr int stage_bytes(int es, int CHB, int P, int N) {
  return 2 * align128(T * CHB * es) + align128(T * CHB * 4) + 2 * align128(T * P * es) +
         align128(CHB * N * 4);
}
__host__ __device__ constexpr int red_bytes(int P) { return align128(2 * T * NW * 2 * P * 4); }
__host__ __device__ constexpr int carry_bytes(int NL, int npass) {
  return align128(2 * npass * NL * NTB * 4);
}
__host__ __device__ constexpr int bwd_smem(int es, int L, int P, int N, int npass) {
  return STAGES * stage_bytes(es, NTB / L * npass, P, N) + red_bytes(P) +
         carry_bytes(P / L, npass) + 128;
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sums v[0, M) over the lanes whose bits O, O / 2, ..., L differ (the
// warp's channels), by recursive halving: at each bit a lane keeps half of
// its values, sends the other half to its partner and adds what it
// receives, in a fixed order.  Afterwards the lane holds the sums of
// values [base, base + max(1, M / 2^steps)); where fewer values than bits
// remained, the last bits add whole (the lanes with any `dup` bit set hold
// a copy).
template <int O, int M, int L, int CAP>
__device__ __forceinline__ void scatter_sum(float (&v)[CAP], int lane, int& base, int& dup) {
  if constexpr (O >= L && O > 0) {
    if constexpr (M > 1) {
      constexpr int H = M / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[H + i];
        const float keep = up ? v[H + i] : v[i];
        v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, O));
      }
      if (up) base += H;
      scatter_sum<O / 2, H, L>(v, lane, base, dup);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], O));
      dup |= O;
      scatter_sum<O / 2, 1, L>(v, lane, base, dup);
    }
  }
}

// Where a block's tiles sit in shared memory.
struct BwdGeom {
  int stage, xb, yb, bb;  // a stage's bytes; offsets of dt, dy, B (C after B)
  int chb, c0, nch, b, K;
};

// Fills the ring's stage for the it-th segment from the end (segment
// K - 1 - it): by TMA from one thread, or by the block's threads (zeros
// past S, d and N, as TMA gives them).
template <typename Tin, int P>
__device__ __forceinline__ void fill_bwd(const BwdMaps* maps, const BwdArgs& a,
                                         unsigned char* smem, uint64_t* full, const BwdGeom& g,
                                         int it) {
  const int k = g.K - 1 - it, t0 = k * T, tid = threadIdx.x, es = (int)sizeof(Tin);
  unsigned char* st = smem + (it % STAGES) * g.stage;
  Tin* xs = reinterpret_cast<Tin*>(st);
  Tin* ts = reinterpret_cast<Tin*>(st + g.xb);
  float* ys = reinterpret_cast<float*>(st + 2 * g.xb);
  Tin* bs = reinterpret_cast<Tin*>(st + 2 * g.xb + g.yb);
  Tin* cs = reinterpret_cast<Tin*>(st + 2 * g.xb + g.yb + g.bb);
  float* hs = reinterpret_cast<float*>(st + 2 * g.xb + g.yb + 2 * g.bb);
  const int S = a.S, d = a.d, N = a.N, b = g.b, c0 = g.c0;
  const float* hsrc = a.states + (((long long)b * g.K + k) * d + c0) * N;
  if (a.tma) {
    if (tid == 0) {
      uint64_t* bar = &full[it % STAGES];
      bar_arrive_expect(bar, (uint32_t)(T * g.chb * (2 * es + 4) + 2 * T * P * es +
                                        g.nch * N * 4));
      tma_load_3d(xs, &maps->x, bar, c0, t0, b);
      tma_load_3d(ts, &maps->dt, bar, c0, t0, b);
      tma_load_3d(ys, &maps->dy, bar, c0, t0, b);
      tma_load_3d(bs, &maps->B, bar, 0, t0, b);
      tma_load_3d(cs, &maps->C, bar, 0, t0, b);
      bulk_load(hs, hsrc, (uint32_t)(g.nch * N * 4), bar);
    }
    return;
  }
  const Tin* x = static_cast<const Tin*>(a.x);
  const Tin* dt = static_cast<const Tin*>(a.dt);
  for (int e = tid; e < T * g.chb; e += NTB) {
    const int t = t0 + e / g.chb, cc = c0 + e % g.chb;
    const bool ok = t < S && cc < d;
    const long long i = ((long long)b * S + t) * d + cc;
    xs[e] = ok ? x[i] : Tin(0.f);
    ts[e] = ok ? dt[i] : Tin(0.f);
    ys[e] = ok ? a.dy[i] : 0.f;
  }
  const Tin* Bm = static_cast<const Tin*>(a.Bm);
  const Tin* Cm = static_cast<const Tin*>(a.Cm);
  for (int e = tid; e < T * P; e += NTB) {
    const int t = t0 + e / P, n = e % P;
    const bool ok = t < S && n < N;
    const long long r = (long long)b * S + t;
    bs[e] = ok ? Bm[r * a.bstride + n] : Tin(0.f);
    cs[e] = ok ? Cm[r * a.cstride + n] : Tin(0.f);
  }
  for (int e = tid; e < g.nch * N; e += NTB) hs[e] = hsrc[e];
}

template <typename Tin, int L, int NL>
__global__ void __launch_bounds__(NTB)
ssm_scan_bwd_kernel(const __grid_constant__ BwdMaps maps, const BwdArgs a) {
  constexpr int P = L * NL, CH = NTB / L;
  constexpr int SB = NL <= 4 ? T : T / 4;  // steps a sub-block: h_{t-1}, decay_t in registers
  constexpr int NSB = T / SB;
  constexpr int W = 32 / L;                         // channels a warp
  constexpr int MF = 2 * NL >= W ? 2 * NL / W : 1;  // sums a lane holds after the scatter
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = a.S, d = a.d, N = a.N, npass = a.npass;
  BwdGeom g;
  g.chb = CH * npass;  // channels a block
  g.xb = align128(T * g.chb * (int)sizeof(Tin));
  g.yb = align128(T * g.chb * 4);
  g.bb = align128(T * P * (int)sizeof(Tin));
  g.stage = stage_bytes(sizeof(Tin), g.chb, P, N);
  g.b = blockIdx.y;
  g.c0 = blockIdx.x * g.chb;
  g.nch = min(g.chb, d - g.c0);
  g.K = (S + T - 1) / T;
  const int K = g.K, b = g.b, c0 = g.c0, CHB = g.chb;
  float* red = reinterpret_cast<float*>(smem + STAGES * g.stage);  // [2][T][NW][2P]
  float* carry_s = reinterpret_cast<float*>(smem + STAGES * g.stage + red_bytes(P));
  float* da_s = carry_s + npass * NL * NTB;  // both [npass][NL][NTB]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * g.stage + red_bytes(P) +
                                               carry_bytes(NL, npass));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, j = tid % L;

  for (int i = 0; i < npass * NL; ++i) carry_s[i * NTB + tid] = da_s[i * NTB + tid] = 0.f;
  if (a.tma && tid == 0) {
    for (int s = 0; s < STAGES; ++s) bar_init(&full[s], 1);
    bar_init_fence();
  }
  __syncthreads();
  // the maps stay in the kernel's parameter space, where TMA reads them
  for (int it = 0; it < STAGES && it < K; ++it) fill_bwd<Tin, P>(&maps, a, smem, full, g, it);
  if (!a.tma) __syncthreads();

  for (int it = 0; it < K; ++it) {
    const int t0 = (K - 1 - it) * T;
    if (a.tma) bar_wait(&full[it % STAGES], (it / STAGES) & 1);
    const unsigned char* st = smem + (it % STAGES) * g.stage;
    const Tin* xs = reinterpret_cast<const Tin*>(st);
    const Tin* ts = reinterpret_cast<const Tin*>(st + g.xb);
    const float* ys = reinterpret_cast<const float*>(st + 2 * g.xb);
    const Tin* bs = reinterpret_cast<const Tin*>(st + 2 * g.xb + g.yb) + j * NL;
    const Tin* cs = reinterpret_cast<const Tin*>(st + 2 * g.xb + g.yb + g.bb) + j * NL;
    const float* hs = reinterpret_cast<const float*>(st + 2 * g.xb + g.yb + 2 * g.bb);
    float* rd = red + (it & 1) * (T * NW * 2 * P);

    for (int pass = 0; pass < npass; ++pass) {
      const int cl = pass * CH + tid / L, c = c0 + cl;
      const bool live = c < d;
      float av[NL], carry[NL], da[NL];
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const int n = j * NL + i;
        // dead states: A 0, h 0 (and zeros in B and C)
        av[i] = live && n < N ? __ldg(a.A + (long long)c * N + n) : 0.f;
        carry[i] = carry_s[(pass * NL + i) * NTB + tid];
        da[i] = da_s[(pass * NL + i) * NTB + tid];
      }
#pragma unroll
      for (int q = NSB - 1; q >= 0; --q) {
        float hh[NL], hp[SB][NL], dc[SB][NL];
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const int n = j * NL + i;
          hh[i] = live && n < N ? hs[cl * N + n] : 0.f;  // the stored state
        }
        // the segment forward from its stored state: up to the sub-block,
        // then through it with h_{t-1} and decay_t kept
#pragma unroll
        for (int s = 0; s < (q + 1) * SB; ++s) {
          float bv[NL];
          load_f32<Tin, NL>(bs + s * P, bv);
          const float tv = to_f(ts[s * CHB + cl]);
          const float dtx = __fmul_rn(tv, to_f(xs[s * CHB + cl]));
#pragma unroll
          for (int i = 0; i < NL; ++i) {
            const float dec = expf(__fmul_rn(tv, av[i]));
            if (s >= q * SB) {
              hp[s - q * SB][i] = hh[i];
              dc[s - q * SB][i] = dec;
            }
            hh[i] = __fadd_rn(__fmul_rn(dec, hh[i]), __fmul_rn(dtx, bv[i]));
          }
        }
        // ... and backward, hh holding h_t of the step walked
#pragma unroll
        for (int s2 = SB - 1; s2 >= 0; --s2) {
          const int s = q * SB + s2, t = t0 + s;
          float bv[NL], cv[NL];
          load_f32<Tin, NL>(bs + s * P, bv);
          load_f32<Tin, NL>(cs + s * P, cv);
          const float tv = to_f(ts[s * CHB + cl]), xv = to_f(xs[s * CHB + cl]);
          const float yv = ys[s * CHB + cl];
          const float dtx = __fmul_rn(tv, xv);
          float sgb = 0.f, sdd = 0.f, v[2 * NL];  // v: dB's terms, then dC's
#pragma unroll
          for (int i = 0; i < NL; ++i) {
            const float gv = __fadd_rn(__fmul_rn(yv, cv[i]), carry[i]);
            const float dd = __fmul_rn(__fmul_rn(gv, hp[s2][i]), dc[s2][i]);  // dL/d(dt A)
            da[i] = __fmaf_rn(dd, tv, da[i]);
            sdd = __fmaf_rn(dd, av[i], sdd);
            sgb = __fmaf_rn(gv, bv[i], sgb);
            v[i] = __fmul_rn(gv, dtx);
            v[NL + i] = __fmul_rn(yv, hh[i]);
            carry[i] = __fmul_rn(dc[s2][i], gv);
            hh[i] = hp[s2][i];
          }
#pragma unroll
          for (int o = L >> 1; o > 0; o >>= 1) {
            sgb = __fadd_rn(sgb, __shfl_xor_sync(0xffffffffu, sgb, o));
            sdd = __fadd_rn(sdd, __shfl_xor_sync(0xffffffffu, sdd, o));
          }
          if (j == 0 && live && t < S) {
            const long long o = ((long long)b * S + t) * d + c;
            static_cast<Tin*>(a.ddt)[o] = from_f<Tin>(__fmaf_rn(xv, sgb, sdd));
            static_cast<Tin*>(a.dx)[o] = from_f<Tin>(__fmul_rn(tv, sgb));
          }
          // dB's and dC's terms summed over the warp's channels
          int base = 0, dup = 0;
          scatter_sum<16, 2 * NL, L>(v, lane, base, dup);
          if ((lane & dup) == 0) {
            float* row = rd + (s * NW + warp) * 2 * P;
#pragma unroll
            for (int m = 0; m < MF; ++m) {
              const int idx = base + m;
              float* out = row + (idx / NL) * P + j * NL + idx % NL;
              *out = pass == 0 ? v[m] : __fadd_rn(*out, v[m]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        carry_s[(pass * NL + i) * NTB + tid] = carry[i];
        da_s[(pass * NL + i) * NTB + tid] = da[i];
      }
    }
    __syncthreads();  // the stage and this segment's sums are complete
    if (it + STAGES < K) fill_bwd<Tin, P>(&maps, a, smem, full, g, it + STAGES);
    // dB and dC of the segment: the block's warps added in order
    for (int e = tid; e < T * 2 * N; e += NTB) {
      const int s = e / (2 * N), r = e % (2 * N), q = r / N, n = r % N, t = t0 + s;
      if (t >= S) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) sum = __fadd_rn(sum, rd[(s * NW + w) * 2 * P + q * P + n]);
      a.part_bc[((((long long)q * gridDim.x + blockIdx.x) * a.B + b) * S + t) * N + n] = sum;
    }
  }
  for (int pass = 0; pass < npass; ++pass) {
    const int c = c0 + pass * CH + tid / L;
    if (c >= d) continue;
#pragma unroll
    for (int i = 0; i < NL; ++i)
      if (j * NL + i < N)
        a.part_a[((long long)b * d + c) * N + j * NL + i] = da_s[(pass * NL + i) * NTB + tid];
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

using BwdKernel = void (*)(const BwdMaps, const BwdArgs);

// The lanes a channel at P states (the wrapper's plan takes the same).
constexpr int lanes_for(int P) { return P <= 4 ? 1 : P == 8 ? 2 : 4; }

// The backward kernel at P, the power of two at least N (1 to 32).
template <typename Tin>
BwdKernel pick_kernel(int P) {
  return P == 1    ? ssm_scan_bwd_kernel<Tin, 1, 1>
         : P == 2  ? ssm_scan_bwd_kernel<Tin, 1, 2>
         : P == 4  ? ssm_scan_bwd_kernel<Tin, 1, 4>
         : P == 8  ? ssm_scan_bwd_kernel<Tin, 2, 4>
         : P == 16 ? ssm_scan_bwd_kernel<Tin, 4, 4>
                   : ssm_scan_bwd_kernel<Tin, 4, 8>;
}

int pow2_at_least(int N) {
  int P = 1;
  while (P < N) P <<= 1;
  return P;
}

template <typename Tin>
int launch(BwdArgs a, float* dB, float* dC, float* dA, int nslab, int smem,
           cudaStream_t stream) {
  const int dtype = sizeof(Tin) == 2 ? 1 : 0;
  const int P = pow2_at_least(a.N), lanes = lanes_for(P);
  const BwdKernel kernel = pick_kernel<Tin>(P);
  const int CHB = NTB / lanes * a.npass;
  if (a.npass < 1 || CHB > 256 || nslab != (a.d + CHB - 1) / CHB ||
      smem != bwd_smem(sizeof(Tin), lanes, P, a.N, a.npass))
    return -3;
  BwdMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (a.tma) {
    int e;
    if ((e = tensor_map_rows(&maps.x, dtype, a.x, a.d, a.d, a.S, a.B, CHB, T)) != 0) return e;
    if ((e = tensor_map_rows(&maps.dt, dtype, a.dt, a.d, a.d, a.S, a.B, CHB, T)) != 0) return e;
    if ((e = tensor_map_rows(&maps.dy, 0, a.dy, a.d, a.d, a.S, a.B, CHB, T)) != 0) return e;
    if ((e = tensor_map_rows(&maps.B, dtype, a.Bm, a.N, a.bstride, a.S, a.B, P, T)) != 0)
      return e;
    if ((e = tensor_map_rows(&maps.C, dtype, a.Cm, a.N, a.cstride, a.S, a.B, P, T)) != 0)
      return e;
  }
  int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  dim3 grid(nslab, a.B);
  kernel<<<grid, NTB, smem, stream>>>(maps, a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const long long bsn = (long long)a.B * a.S * a.N;
  if ((err = reduce(a.part_bc, dB, nslab, bsn, stream)) != 0) return err;
  if ((err = reduce(a.part_bc + (long long)nslab * bsn, dC, nslab, bsn, stream)) != 0) return err;
  return reduce(a.part_a, dA, a.B, (long long)a.d * a.N, stream);
}

}  // namespace

// C interface, loaded with ctypes.  dtype (of x, dt, B and C alike): 0 =
// float32, 1 = bfloat16.  x, dt, dy contiguous (B, S, d); B and C (B, S, N)
// with unit element stride and rows bstride / cstride elements apart; A
// contiguous (d, N); states contiguous (B, ceil(S / 16), d, N); the
// outputs contiguous: dx, ddt (B, S, d) in the inputs' dtype, dB, dC (B,
// S, N) and dA (d, N) float32; scratch part_bc (2, nslab, B, S, N) and
// part_a (B, d, N) float32.  The plan is the wrapper's: `npass` (channel
// groups a block), `nslab` (blocks along d: ceil(d / (128 / L * npass)),
// L the lanes a channel at N), `tma` (1: TMA loads, which need 16-byte
// aligned x, dt, dy, B, C and states and 16-byte row strides; 0: the
// threads' loads) and `smem` (dynamic shared memory bytes, checked against
// the kernel's own count).  Returns 0, a cudaError_t, or -1 / -2 / -3 / -4
// for an unsupported dtype / state size / plan / tensor map.
extern "C" int repro_ssm_scan_bwd(int dtype, const void* x, const void* dt, const void* Bm,
                                  long long bstride, const void* Cm, long long cstride,
                                  const void* A, const void* dy, const void* states, void* dx,
                                  void* ddt, void* dB, void* dC, void* dA, void* part_bc,
                                  void* part_a, int B, int S, int d, int N, int npass,
                                  int nslab, int tma, int smem, void* stream) {
  if (N < 1 || N > 32) return -2;
  BwdArgs a{x,
            dt,
            Bm,
            Cm,
            bstride,
            cstride,
            static_cast<const float*>(A),
            static_cast<const float*>(dy),
            static_cast<const float*>(states),
            dx,
            ddt,
            static_cast<float*>(part_bc),
            static_cast<float*>(part_a),
            B,
            S,
            d,
            N,
            npass,
            tma};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *o3 = static_cast<float*>(dB), *o4 = static_cast<float*>(dC);
  float* o5 = static_cast<float*>(dA);
  if (dtype == 0) return launch<float>(a, o3, o4, o5, nslab, smem, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, o3, o4, o5, nslab, smem, s);
  return -1;
}

// The steps between the states the backward reads, for the wrapper to
// check against the forward's.
extern "C" int repro_ssm_scan_bwd_state_every() { return T; }
