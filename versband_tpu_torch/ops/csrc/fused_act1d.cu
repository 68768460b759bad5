// Fused alias-free Snake activation for Hopper (sm_90a): kernel K4.
//
// Replaces versband_tpu/ops/fused_act1d.py::_act_kernel, the Pallas TPU kernel
// behind BigVGAN's Activation1d: 2x kaiser-sinc upsample (12 taps), Snake or
// SnakeBeta, 2x kaiser-sinc low-pass and decimate, in one pass. With f the
// sum-normalized taps, g = 2 f, q = k / 4 = 3 (the closed form of the JAX
// kernel's docstring, fused_act1d.py:10-17), per row (b, c) of x [B, C, T]:
//   U[2m]   = ye[m] = sum_a g[k-1-2a] x[m + a - q]          (a = 0..5)
//   U[2m+1] = yo[m] = sum_a g[k-2-2a] x[m + a - q + 1]
//   S[n]    = U[n] + sin^2(alpha U[n]) / (beta + 1e-9)
//   out[t]  = sum_j f[j] S[2t + j - 5]                         (j = 0..11)
// Edges are those of the reference's unfused modules: x is replicate-padded
// (x read at indices clamped to [0, T-1]) and the snaked 2T signal is
// replicate-padded again (S read at n clamped to [0, 2T-1], so
// S[n < 0] = S[0] and S[n >= 2T] = S[2T-1]). Any T >= 1 works.
//
// What bounds it on the card: 24 multiply-adds and 2 Snake evaluations per
// output sample against one read of x and one write of out, about 7 FLOP per
// byte in fp32, far below the ridge (~20 for the fp32 FMA rate): HBM bytes
// bound it (the largest call of a 20 s clip, [1, 32, 481280] fp32, moves
// 123 MB: 0.0368 ms at 3.35 TB/s).
//
// What the design does about that: x is read once and out written once; the
// 2T intermediate never leaves shared memory. Blocks of 256 threads are
// persistent (as many as fit on the SMs) and walk the tiles of 1024 outputs
// of all rows (b, c); a block copies the next tile's x, with 8 samples of
// halo per side, into its second x buffer (cp.async, 16-byte pieces where
// the row allows, clamped to the row sample by sample elsewhere: the
// replicate padding of x) while it computes this tile:
//   1. each thread computes 4 neighbouring (even, odd) pairs of U from a
//      register window of 10 x values (three 16-byte shared loads), snakes
//      the 8 samples and stores them with two 16-byte shared stores; pairs
//      at the row's edges take the clamped path (n clamped to the 2T
//      signal, its replicate padding), as do the 6 pairs past the tile's
//      1024, one each on 6 threads;
//   2. each thread computes 4 neighbouring outputs of the decimating
//      down-FIR from a register window of 20 snaked samples (five 16-byte
//      shared loads) and stores them with one 16-byte (fp32) or 8-byte (bf16)
//      store where the row allows.
// The math is fp32 for fp32 and bf16 inputs; the output has the input's
// type. Snake needs only sin^2, of period pi: the argument is reduced by
// Cody-Waite (k = rint(theta / pi), r = (theta - k pi_hi) - k pi_lo, both
// steps fmaf, the first exact) to [-pi/2, pi/2] and sin(r) is an odd
// polynomial of degree 11 (|error| < 1.1e-7 there), in place of the
// accurate sinf with its slow path for large arguments. Taking one part out
// at a time (kernel_variants.py): Snake is still a third of the time, the
// x copies a quarter.

#include <atomic>

#include "mma_sm90.cuh"  // cp_async_*, smem_u32

namespace {

constexpr int K = 12;               // taps of the 2x resampler
constexpr int Q = K / 4;            // reach of the up-FIR in x samples
constexpr int TILE = 1024;          // output samples per tile
constexpr int THREADS = 256;
constexpr int PAIRS = 4;            // U pairs a thread in stage 1
constexpr int OUTS = 4;             // outputs a thread in stage 2
constexpr int NPAIRS = TILE + 2 * Q;  // pairs m = t0 - Q .. t0 + TILE + Q - 1
constexpr int XPAD = 8;             // xs[j] = x[clamp(t0 - XPAD + j)]
constexpr int NX = 1040;            // x samples staged: the last pair's window, in 16-byte pieces
constexpr int NS = 2064;            // snaked samples: ss[i] = S[2 t0 - 2Q + i], i < 2 NPAIRS
constexpr int MAX_BLOCKS_PER_SM = 8;
static_assert(TILE == PAIRS * THREADS && TILE == OUTS * THREADS, "one group a thread");
static_assert(NX % 8 == 0 && NX >= NPAIRS + 2 * Q + 2 && NS >= 2 * NPAIRS, "windows fit");

// Cody-Waite pi, and the odd polynomial of sin on [-pi/2 - 0.01, pi/2 + 0.01]
constexpr float INV_PI = 0.318309886183790672f;
constexpr float PI_HI = 3.14159274101257324f;    // float(pi)
constexpr float PI_LO = -8.74227766e-08f;        // pi - PI_HI
constexpr float S3 = -1.666666716e-01f, S5 = 8.333331905e-03f, S7 = -1.984091941e-04f,
                S9 = 2.752792398e-06f, S11 = -2.393252885e-08f;

struct Taps {
  float f[K];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// u + sin^2(a u) * inv_b
__device__ __forceinline__ float snake(float u, float a, float inv_b) {
  const float th = a * u;
  const float k = rintf(th * INV_PI);
  float r = fmaf(-k, PI_HI, th);
  r = fmaf(-k, PI_LO, r);
  const float r2 = r * r;
  float p = fmaf(S11, r2, S9);
  p = fmaf(p, r2, S7);
  p = fmaf(p, r2, S5);
  p = fmaf(p, r2, S3);
  const float s = fmaf(r * r2, p, r);
  return fmaf(inv_b * s, s, u);
}

// (ye, yo) of the pair whose x window (x[m - Q .. m + Q]) starts at w
template <typename W>
__device__ __forceinline__ void up_pair(const W* w, const Taps& taps, float& ye, float& yo) {
  ye = 0.f;
  yo = 0.f;
#pragma unroll
  for (int ai = 0; ai < K / 2; ++ai) {
    ye = fmaf(2.0f * taps.f[K - 1 - 2 * ai], to_float(w[ai]), ye);
    yo = fmaf(2.0f * taps.f[K - 2 - 2 * ai], to_float(w[ai + 1]), yo);
  }
}

struct Params {
  const void* x;        // [B, C, T] through strides (elements)
  const float* alpha;   // [C]
  const float* beta;    // [C] (alpha: Snake)
  void* out;            // [B, C, T] contiguous
  long long sxb, sxc, sxt;
  int items, C, len, tiles_per_row, logscale;  // items = B C tiles_per_row
  Taps taps;
};

// Issue the copies of x[clamp(t0 - XPAD + j)], j < NX, of row (b, c) into xs:
// 16-byte pieces where they lie inside the row and the row allows them, the
// rest sample by sample from the clamped index (the replicate padding).
template <typename T>
__device__ __forceinline__ void stage_x(const Params& p, const T* xr, long long t0, T* xs) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const bool vec = p.sxt == 1 && reinterpret_cast<uintptr_t>(xr) % 16 == 0;
  for (int j0 = VEC * threadIdx.x; j0 < NX; j0 += VEC * THREADS) {
    const long long t = t0 - XPAD + j0;
    if (vec && t >= 0 && t + VEC <= p.len) {
      cp_async_16(smem_u32(xs + j0), xr + t, 16);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        long long ti = t + i;
        ti = ti < 0 ? 0 : (ti >= p.len ? p.len - 1 : ti);
        if constexpr (sizeof(T) == 4) cp_async_4(smem_u32(xs + j0 + i), xr + ti * p.sxt, 4);
        else xs[j0 + i] = xr[ti * p.sxt];
      }
    }
  }
}

// A tile of the call: row (b, c) = row / C, row % C, first output t0.
struct Item {
  int row, c, t0;
};

__device__ __forceinline__ Item item_at(const Params& p, int item) {
  const int row = item / p.tiles_per_row;
  return {row, row % p.C, (item - row * p.tiles_per_row) * TILE};
}

template <typename T>
__device__ __forceinline__ void issue_item(const Params& p, int item, const Item& it, T* xs) {
  if (item < p.items)
    stage_x<T>(p, static_cast<const T*>(p.x) + (it.row / p.C) * p.sxb + it.c * p.sxc, it.t0, xs);
  cp_async_commit();
}

// (even, odd) snaked pair of pair index q of the tile at t0, from the window
// of m = t0 - Q + q clamped to the row: pairs at m < 0 are both S[0] =
// S(ye[0]), pairs at m >= len both S[2T-1] = S(yo[T-1]).
template <typename T>
__device__ __forceinline__ float2 edge_pair(const T* xs, long long t0, int q, int len,
                                            const Taps& taps, float a, float inv_b) {
  const long long m = t0 - Q + q;
  const long long mc = m < 0 ? 0 : (m >= len ? len - 1 : m);
  float ye, yo;
  up_pair(xs + (mc - t0) + XPAD - Q, taps, ye, yo);
  const float se = snake(ye, a, inv_b), so = snake(yo, a, inv_b);
  return make_float2(m >= len ? so : se, m < 0 ? se : so);
}

// Persistent blocks walk the tiles (b, c, tile) of the call; each stages the
// next tile's x while it computes this one (two x buffers).
template <typename T>
__global__ void __launch_bounds__(THREADS) act1d_kernel(const Params p) {
  __shared__ __align__(16) T xbuf[2][NX];
  __shared__ __align__(16) float ss[NS];
  const Taps& taps = p.taps;

  Item next = item_at(p, blockIdx.x);
  issue_item<T>(p, blockIdx.x, next, xbuf[0]);
  int buf = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x, buf ^= 1) {
    const Item it = next;
    next = item_at(p, item + gridDim.x);
    issue_item<T>(p, item + gridDim.x, next, xbuf[buf ^ 1]);
    cp_async_wait<1>();
    __syncthreads();  // this tile's x is in; the last tile's stage 2 is done with ss

    const int c = it.c, len = p.len, t0 = it.t0;
    float a = p.alpha[c], bt = p.beta[c];
    if (p.logscale) {
      a = expf(a);
      bt = expf(bt);
    }
    const float inv_b = 1.0f / (bt + 1e-9f);
    const T* xs = xbuf[buf];

    // 1. U pairs q = PAIRS tid .. + PAIRS - 1 (m = t0 - Q + q) from one
    // register window xs[q0 .. q0 + 11] (pair q's window starts at xs[q + 2]),
    // snaked into ss[2q], ss[2q + 1]; the 2Q pairs past the groups one each.
    {
      const int q0 = PAIRS * threadIdx.x;
      const long long m0 = t0 - Q + q0;
      float s[2 * PAIRS];
      if (m0 >= 0 && m0 + PAIRS <= len) {
        float w[12];
        if constexpr (sizeof(T) == 4) {
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const float4 v = reinterpret_cast<const float4*>(xs + q0)[i];
            w[4 * i] = v.x;
            w[4 * i + 1] = v.y;
            w[4 * i + 2] = v.z;
            w[4 * i + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const uint2 v = reinterpret_cast<const uint2*>(xs + q0)[i];
            const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
            for (int k = 0; k < 4; ++k) w[4 * i + k] = __bfloat162float(e[k]);
          }
        }
#pragma unroll
        for (int pr = 0; pr < PAIRS; ++pr) {
          float ye, yo;
          up_pair(w + XPAD - 2 * Q + pr, taps, ye, yo);
          s[2 * pr] = snake(ye, a, inv_b);
          s[2 * pr + 1] = snake(yo, a, inv_b);
        }
      } else {
#pragma unroll
        for (int pr = 0; pr < PAIRS; ++pr) {
          const float2 e = edge_pair(xs, t0, q0 + pr, len, taps, a, inv_b);
          s[2 * pr] = e.x;
          s[2 * pr + 1] = e.y;
        }
      }
      float4* dst = reinterpret_cast<float4*>(ss + 2 * q0);
      dst[0] = make_float4(s[0], s[1], s[2], s[3]);
      dst[1] = make_float4(s[4], s[5], s[6], s[7]);
      if (threadIdx.x < 2 * Q) {
        const int q = TILE + threadIdx.x;
        *reinterpret_cast<float2*>(ss + 2 * q) = edge_pair(xs, t0, q, len, taps, a, inv_b);
      }
    }
    __syncthreads();  // ss is written; every thread is done with this x buffer

    // 2. out[t0 + tt], tt = OUTS tid .. + OUTS - 1: sum_j f[j] ss[2 tt + j + 1],
    // from one register window ss[2 u0 .. 2 u0 + 19].
    const int u0 = OUTS * threadIdx.x;
    float w[20];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const float4 v = reinterpret_cast<const float4*>(ss + 2 * u0)[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
    float acc[OUTS];
#pragma unroll
    for (int o = 0; o < OUTS; ++o) {
      acc[o] = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) acc[o] = fmaf(taps.f[j], w[2 * o + j + 1], acc[o]);
    }
    T* orow = static_cast<T*>(p.out) + (long long)it.row * len;
    const int t = t0 + u0;
    if (t + OUTS <= len && reinterpret_cast<uintptr_t>(orow + t) % (OUTS * sizeof(T)) == 0) {
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(orow + t) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
        __nv_bfloat162 lo = __floats2bfloat162_rn(acc[0], acc[1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(acc[2], acc[3]);
        uint2 v;
        v.x = *reinterpret_cast<uint32_t*>(&lo);
        v.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(orow + t) = v;
      }
    } else {
#pragma unroll
      for (int o = 0; o < OUTS; ++o)
        if (t + o < len) store(orow + t + o, acc[o]);
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  // Resident blocks per SM and SMs per device: read on the first launch on
  // each device, not on every launch (host time).
  static std::atomic<int> slots[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  int n = slots[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, act1d_kernel<T>, THREADS, 0);
    if (err != cudaSuccess) return err;
    n = sms * max(1, min(per_sm, MAX_BLOCKS_PER_SM));
    slots[dev].store(n, std::memory_order_relaxed);
  }
  const int blocks = min(p.items, n);
  act1d_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x [B, C, T] through strides (elements), alpha/beta fp32 [C] (beta may be
// alpha: Snake), out [B, C, T] contiguous in x's type; taps: the 12 host
// floats of kaiser_sinc_filter1d(0.25, 0.3, 12). Returns cudaGetLastError().
extern "C" int vbt_fused_act1d(const void* x, const float* alpha, const float* beta, void* out,
                               int B, int C, int T, long long sxb, long long sxc, long long sxt,
                               int logscale, const float* taps, int is_bf16, void* stream) {
  const long long tpr = ((long long)T + TILE - 1) / TILE;
  if (B <= 0 || C <= 0 || T <= 0 || (long long)B * C * tpr > 0x3fffffffLL)  // item + grid: int
    return (int)cudaErrorInvalidValue;
  Params p{x, alpha, beta, out, sxb, sxc, sxt, (int)(B * C * tpr), C, T, (int)tpr, logscale, {}};
  for (int j = 0; j < K; ++j) p.taps.f[j] = taps[j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s));
}
