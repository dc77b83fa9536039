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
// src/repro/models/ssm.py: x and dt (B, S, d), B and C (B, S, N) with row
// strides (the strided slices of the model's x_proj output go in without a
// copy) and A (d, N) go in, and decay = exp(dt A) and inc = (dt x) B are
// built in registers with the operation order of the port's `decay_inc`
// (the product dt A rounded, then an accurate expf; dt x rounded, then
// times B), so the two (B, S, d, N) f32 tensors never reach device memory.
// With a `states` buffer it also writes h every STATE_EVERY steps (the
// state before steps 0, T, 2T, ...; (B, ceil(S / T), d, N) f32), from which
// the backward (ssm_scan_bwd.cu) recomputes a segment; without one
// (serving) it writes nothing more than y.
//
// What bounds the fused form: the B S d N exponentials on the SFUs (16 a
// clock an SM), more than its bytes (x, dt read once, y written once); the
// accurate expf's range reduction and the recurrence put some 14 f32
// operations a state and step on the FMA pipes beside it.  Its design:
//  * A channel a thread: it holds the channel's P = next_pow2(N) states in
//    registers for the whole sequence (those past N stay 0), so dt x is
//    computed once a channel and step, y_t is summed in the thread and
//    every state and step costs one exponential.  (Two or four lanes a
//    channel, N / L states each, ran slower at both of falcon-mamba's
//    shapes on the H100: PERF.md.)
//  * The inputs are staged in shared memory, TC steps at a time, through a
//    ring of STAGES stages: the x and dt rows of the block's channels and
//    the B and C rows (the same for every channel of a batch row, read as
//    16-byte broadcasts).  One thread refills a stage by TMA (a tensor map
//    a tile, completion on the stage's mbarrier) as soon as the block is
//    done with it, so the next STAGES - 1 chunks are in flight while one is
//    computed.  TMA needs 16-byte aligned rows; where the wrapper finds
//    that missing it asks for the second load path, the block's threads
//    copying the same tiles (never a fall back after a failure).  Either
//    way elements past S, d or N arrive as zeros: dt = 0 gives decay 1 and
//    inc 0, so those states and steps leave h as it is.
//  * y is stored a row of channels a step, the states as a thread's N
//    contiguous floats every STATE_EVERY steps (float4 stores where N is a
//    power of two from 4 up).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "tma.cuh"

namespace {

using namespace hopper;

constexpr int NT = 128;          // threads per block: NT / P channels
constexpr int U = 8;             // time steps loaded ahead of the recurrence
constexpr int STATE_EVERY = 16;  // steps between stored states

// The fused kernel's blocks: FT threads (a channel each), TC steps a
// stage, STAGES stages in the ring.
constexpr int FT = 128;
constexpr int TC = 32;  // a multiple of STATE_EVERY
constexpr int STAGES = 3;

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

// One thread per state element (b, ch, n) for the whole sequence: the
// recurrence and y_t by a shuffle sum over the channel's P lanes.  P is a
// template argument so that the shuffle sums unroll and the U steps' sums
// overlap.
template <int P, class Loader>
__device__ __forceinline__ void scan_body(Loader ld, float* __restrict__ y, int S, int d, int N) {
  const int n = threadIdx.x % P;  // P divides 32, so a channel never spans two warps
  const int ch = blockIdx.x * (NT / P) + threadIdx.x / P;
  const long long b = blockIdx.y;
  const bool live = ch < d && n < N;  // dead lanes still join the shuffles
  ld.start(b, live ? ch : 0, live ? n : 0, S, d, N);
  float* yp = y + b * S * d + (live ? ch : 0);

  typename Loader::Raw cur[U], nxt[U];  // steps t0 .. t0 + U - 1, and the next U in flight
#pragma unroll
  for (int u = 0; u < U; ++u) cur[u] = ld.load(u, live && u < S);

  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) nxt[u] = ld.load(t0 + U + u, live && t0 + U + u < S);
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
  scan_body<P>(ld, y, S, d, N);
}

// ------------------------------------------------------------ fused form --
struct FusedArgs {
  const void *x, *dt, *Bm, *Cm;
  long long bstride, cstride;
  const float* A;
  float* y;
  float* states;
  int S, d, N, tma;
};
struct FusedMaps {
  CUtensorMap x, dt, B, C;  // unused on the threads' load path
};

// A stage of the ring: x and dt [TC][FT], B and C [TC][P] (P columns,
// those past N zero), each tile 128-byte aligned; the ring's mbarriers
// after it.
template <typename T, int P>
struct FusedStage {
  static constexpr int XB = align128(TC * FT * (int)sizeof(T));
  static constexpr int BB = align128(TC * P * (int)sizeof(T));
  static constexpr int BYTES = 2 * XB + 2 * BB;
  static constexpr uint32_t TX = 2u * TC * FT * sizeof(T) + 2u * TC * P * sizeof(T);
};

__host__ __device__ constexpr int fused_smem(int es, int P) {
  return STAGES * (2 * align128(TC * FT * es) + 2 * align128(TC * P * es)) + 128;
}

// Fills the ring's stage for chunk k: by TMA from one thread, or by the
// block's threads (zeros past S, d and N, as TMA gives them).
template <typename T, int P>
__device__ __forceinline__ void fill_fused(const FusedMaps* maps, const FusedArgs& a,
                                           unsigned char* smem, uint64_t* full, int c0, int b,
                                           int k) {
  using Stage = FusedStage<T, P>;
  unsigned char* st = smem + (k % STAGES) * Stage::BYTES;
  T* xs = reinterpret_cast<T*>(st);
  T* ts = reinterpret_cast<T*>(st + Stage::XB);
  T* bs = reinterpret_cast<T*>(st + 2 * Stage::XB);
  T* cs = reinterpret_cast<T*>(st + 2 * Stage::XB + Stage::BB);
  const int t0 = k * TC, tid = threadIdx.x;
  if (a.tma) {
    if (tid == 0) {
      uint64_t* bar = &full[k % STAGES];
      bar_arrive_expect(bar, Stage::TX);
      tma_load_3d(xs, &maps->x, bar, c0, t0, b);
      tma_load_3d(ts, &maps->dt, bar, c0, t0, b);
      tma_load_3d(bs, &maps->B, bar, 0, t0, b);
      tma_load_3d(cs, &maps->C, bar, 0, t0, b);
    }
    return;
  }
  const int S = a.S, d = a.d, N = a.N;
  const T* x = static_cast<const T*>(a.x);
  const T* dt = static_cast<const T*>(a.dt);
  for (int e = tid; e < TC * FT; e += FT) {
    const int t = t0 + e / FT, cc = c0 + e % FT;
    const bool ok = t < S && cc < d;
    const long long i = ((long long)b * S + t) * d + cc;
    xs[e] = ok ? x[i] : T(0.f);
    ts[e] = ok ? dt[i] : T(0.f);
  }
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  for (int e = tid; e < TC * P; e += FT) {
    const int t = t0 + e / P, n = e % P;
    const bool ok = t < S && n < N;
    const long long r = (long long)b * S + t;
    bs[e] = ok ? Bm[r * a.bstride + n] : T(0.f);
    cs[e] = ok ? Cm[r * a.cstride + n] : T(0.f);
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(FT)
ssm_scan_fused_kernel(const __grid_constant__ FusedMaps maps, const FusedArgs a) {
  using Stage = FusedStage<T, P>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * Stage::BYTES);
  const int tid = threadIdx.x;
  const int S = a.S, d = a.d, N = a.N;
  const int c0 = blockIdx.x * FT, b = blockIdx.y, c = c0 + tid;
  const bool live = c < d;
  const int chunks = (S + TC - 1) / TC;

  if (a.tma && tid == 0) {
    for (int s = 0; s < STAGES; ++s) bar_init(&full[s], 1);
    bar_init_fence();
  }
  __syncthreads();
  // the maps stay in the kernel's parameter space, where TMA reads them
  for (int k = 0; k < STAGES && k < chunks; ++k)
    fill_fused<T, P>(&maps, a, smem, full, c0, b, k);

  float av[P], h[P];
#pragma unroll
  for (int n = 0; n < P; ++n) {
    av[n] = live && n < N ? a.A[(long long)c * N + n] : 0.f;  // 0: decay 1, h stays 0
    h[n] = 0.f;
  }
  const long long K = (S + STATE_EVERY - 1) / STATE_EVERY;
  float* sp = a.states != nullptr && live ? a.states + ((long long)b * K * d + c) * N : nullptr;
  const bool vec = N == P && P % 4 == 0 && (reinterpret_cast<uintptr_t>(a.states) & 15) == 0;
  float* yp = a.y + (long long)b * S * d + c;
  if (!a.tma) __syncthreads();

  for (int k = 0; k < chunks; ++k) {
    if (a.tma) bar_wait(&full[k % STAGES], (k / STAGES) & 1);
    const unsigned char* st = smem + (k % STAGES) * Stage::BYTES;
    const T* xs = reinterpret_cast<const T*>(st) + tid;
    const T* ts = reinterpret_cast<const T*>(st + Stage::XB) + tid;
    const T* bs = reinterpret_cast<const T*>(st + 2 * Stage::XB);
    const T* cs = reinterpret_cast<const T*>(st + 2 * Stage::XB + Stage::BB);
    for (int g = 0; g < TC / STATE_EVERY; ++g) {
      const int tg = k * TC + g * STATE_EVERY;
      if (tg >= S) break;  // the same for the whole block
      if (sp != nullptr) {
        float* out = sp + (long long)(tg / STATE_EVERY) * d * N;
        if (vec) {
#pragma unroll
          for (int n = 0; n < P; n += 4)
            *reinterpret_cast<float4*>(out + n) = make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
        } else {
#pragma unroll
          for (int n = 0; n < P; ++n)
            if (n < N) out[n] = h[n];
        }
      }
#pragma unroll 4
      for (int i = 0; i < STATE_EVERY; ++i) {
        const int r = g * STATE_EVERY + i;
        Row<T, P> bv, cv;
        bv.load(bs + r * P);
        cv.load(cs + r * P);
        const float tv = to_f(ts[r * FT]);
        const float dtx = __fmul_rn(tv, to_f(xs[r * FT]));
        float y = 0.f;
#pragma unroll
        for (int n = 0; n < P; ++n) {
          const float dc = expf(__fmul_rn(tv, av[n]));
          h[n] = __fadd_rn(__fmul_rn(dc, h[n]), __fmul_rn(dtx, bv[n]));
          y = fmaf(h[n], cv[n], y);
        }
        if (live && tg + i < S) yp[(long long)(tg + i) * d] = y;
      }
    }
    __syncthreads();  // the stage is read: refill it
    if (k + STAGES < chunks) fill_fused<T, P>(&maps, a, smem, full, c0, b, k + STAGES);
  }
}

int pow2_at_least(int N) {
  int P = 1;
  while (P < N) P <<= 1;
  return P;
}

// The instantiation of `kernel` for P, the power of two at least N (1 to 32).
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
int launch_fused(FusedArgs a, int B, int smem, cudaStream_t stream) {
  const int dtype = sizeof(T) == 2 ? 1 : 0;
  const int P = pow2_at_least(a.N);
  const auto kernel = PICK_P(ssm_scan_fused_kernel, T, P);
  if (smem != fused_smem(sizeof(T), P)) return -3;
  FusedMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (a.tma) {
    int e;
    if ((e = tensor_map_rows(&maps.x, dtype, a.x, a.d, a.d, a.S, B, FT, TC)) != 0) return e;
    if ((e = tensor_map_rows(&maps.dt, dtype, a.dt, a.d, a.d, a.S, B, FT, TC)) != 0) return e;
    if ((e = tensor_map_rows(&maps.B, dtype, a.Bm, a.N, a.bstride, a.S, B, P, TC)) != 0) return e;
    if ((e = tensor_map_rows(&maps.C, dtype, a.Cm, a.N, a.cstride, a.S, B, P, TC)) != 0) return e;
  }
  int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  dim3 grid((a.d + FT - 1) / FT, B);
  kernel<<<grid, FT, smem, stream>>>(maps, a);
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
// before every STATE_EVERY-th step.  The plan is the wrapper's: `tma` (1:
// TMA loads, which need 16-byte aligned x, dt, B and C and 16-byte row
// strides; 0: the threads' loads) and `smem` (the dynamic shared memory
// bytes, checked against the kernel's own count).  Returns 0, a cudaError_t, or -1 / -2 /
// -3 / -4 for an unsupported dtype / state size / plan / tensor map.
extern "C" int repro_ssm_scan_fused_fwd(int dtype, const void* x, const void* dt, const void* Bm,
                                        long long bstride, const void* Cm, long long cstride,
                                        const void* A, void* y, void* states, int B, int S,
                                        int d, int N, int tma, int smem, void* stream) {
  if (N < 1 || N > 32) return -2;
  FusedArgs a{x,  dt, Bm, Cm, bstride, cstride, static_cast<const float*>(A),
              static_cast<float*>(y), static_cast<float*>(states), S, d, N, tma};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fused<float>(a, B, smem, s);
  if (dtype == 1) return launch_fused<__nv_bfloat16>(a, B, smem, s);
  return -1;
}

// The steps between the stored states, for the wrapper to check against
// its own constant.
extern "C" int repro_ssm_scan_state_every() { return STATE_EVERY; }
