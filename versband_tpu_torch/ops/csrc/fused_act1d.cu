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
// 2T intermediate never leaves shared memory. A block of 256 threads owns
// one row (b, c) and a tile of 1024 output samples: it stages the tile's x
// plus 6 samples of halo per side in shared memory (loads clamped to the
// row, which is the replicate padding of x), computes the 2*1024 + 12 snaked
// samples of U the tile's down-FIR reads (n clamped to the 2T signal, which
// is its replicate padding) into shared memory, then the decimating
// down-FIR from there. Rows are contiguous in T in the [B, C, T] layout, so
// every global access is coalesced. The math is fp32 for fp32 and bf16
// inputs, with sinf (not __sinf: |alpha U| reaches several units, where the
// fast intrinsic loses digits); the output has the input's type.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int K = 12;               // taps of the 2x resampler
constexpr int Q = K / 4;            // reach of the up-FIR in x samples
constexpr int HALO = 2 * Q;         // x samples past each tile edge that the tile needs
constexpr int TILE = 1024;          // output samples per block
constexpr int NUM_THREADS = 256;
constexpr int NS = 2 * TILE + 2 * HALO;  // snaked samples of the tile: n = 2 t0 - HALO + i

struct Taps {
  float f[K];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(NUM_THREADS)
act1d_kernel(const T* __restrict__ x, const float* __restrict__ alpha,
             const float* __restrict__ beta, T* __restrict__ out, int C, int len,
             long long sxb, long long sxc, long long sxt, int logscale, Taps taps) {
  __shared__ float xs[TILE + 2 * HALO];  // xs[j] = x[clamp(t0 - HALO + j)]
  __shared__ float ss[NS];               // ss[i] = S[clamp(2 t0 - HALO + i)]

  const int row = blockIdx.x;            // b * C + c
  const int b = row / C, c = row % C;
  const long long t0 = (long long)blockIdx.y * TILE;
  const T* xr = x + b * sxb + c * sxc;

  float a = alpha[c], bt = beta[c];
  if (logscale) {
    a = expf(a);
    bt = expf(bt);
  }
  const float inv_b = 1.0f / (bt + 1e-9f);

  for (int j = threadIdx.x; j < TILE + 2 * HALO; j += NUM_THREADS) {
    long long t = t0 - HALO + j;
    t = t < 0 ? 0 : (t >= len ? len - 1 : t);
    xs[j] = to_float(xr[t * sxt]);
  }
  __syncthreads();

  // One (even, odd) pair of the snaked signal per thread: n = 2m, 2m + 1 with
  // m = t0 - Q + q, from ye and yo at m clamped to the row. Where m < 0 both
  // samples are S[0] = S(ye[0]); where m >= len both are S[2T-1] = S(yo[T-1]).
  // The x indices mc - Q .. mc + Q lie in [t0 - HALO, t0 + TILE + HALO), which
  // xs holds, already clamped to the row.
  for (int q = threadIdx.x; q < NS / 2; q += NUM_THREADS) {
    const long long m = t0 - Q + q;
    const long long mc = m < 0 ? 0 : (m >= len ? len - 1 : m);
    const float* xw = xs + (mc - Q - (t0 - HALO));
    float ye = 0.f, yo = 0.f;
#pragma unroll
    for (int ai = 0; ai < K / 2; ++ai) {
      ye = fmaf(2.0f * taps.f[K - 1 - 2 * ai], xw[ai], ye);
      yo = fmaf(2.0f * taps.f[K - 2 - 2 * ai], xw[ai + 1], yo);
    }
    const float s_e = sinf(a * ye), s_o = sinf(a * yo);
    const float se = fmaf(inv_b * s_e, s_e, ye), so = fmaf(inv_b * s_o, s_o, yo);
    ss[2 * q] = m >= len ? so : se;
    ss[2 * q + 1] = m < 0 ? se : so;
  }
  __syncthreads();

  T* orow = out + (long long)row * len;
  for (int tt = threadIdx.x; tt < TILE; tt += NUM_THREADS) {
    const long long t = t0 + tt;
    if (t >= len) break;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) acc = fmaf(taps.f[j], ss[2 * tt + j + 1], acc);
    store(orow + t, acc);
  }
}

}  // namespace

// x [B, C, T] through strides (elements), alpha/beta fp32 [C] (beta may be
// alpha: Snake), out [B, C, T] contiguous in x's type; taps: the 12 host
// floats of kaiser_sinc_filter1d(0.25, 0.3, 12). Returns cudaGetLastError().
extern "C" int vbt_fused_act1d(const void* x, const float* alpha, const float* beta, void* out,
                               int B, int C, int T, long long sxb, long long sxc, long long sxt,
                               int logscale, const float* taps, int is_bf16, void* stream) {
  const long long tiles = (T + TILE - 1) / TILE;
  if (B <= 0 || C <= 0 || T <= 0 || tiles > 65535) return (int)cudaErrorInvalidValue;
  Taps tp;
  for (int j = 0; j < K; ++j) tp.f[j] = taps[j];
  const dim3 grid((unsigned)(B * C), (unsigned)tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    act1d_kernel<__nv_bfloat16><<<grid, NUM_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), alpha, beta, static_cast<__nv_bfloat16*>(out), C,
        T, sxb, sxc, sxt, logscale, tp);
  else
    act1d_kernel<float><<<grid, NUM_THREADS, 0, s>>>(static_cast<const float*>(x), alpha, beta,
                                                     static_cast<float*>(out), C, T, sxb, sxc,
                                                     sxt, logscale, tp);
  return (int)cudaGetLastError();
}
