// Fused gated-WaveNet residual layer for Hopper (sm_90a): kernel K5.
//
// Replaces versband_tpu/ops/fused_wavenet.py::_layer_kernel, the Pallas TPU
// kernel of one ParallelWaveGAN residual layer. Per sample t of a batch row,
// with x [R, T], c [A, T], the fp32 skip accumulator [S, T] and dilation d:
//   gate = W0 x[t-d] + W1 x[t] + W2 x[t+d] + Wc c[t] + b_g          [2G]
//   z    = tanh(gate[:G]) * sigmoid(gate[G:])                          [G]
//   skip' = skip + Ws z + b_s                                          [S]
//   x'    = (Wo z + b_o + x[t]) * sqrt(1/2)                            [R]
// x is 0 outside [0, T) (the conv's zero padding); any T >= 1 and d >= 1.
//
// What bounds it on the card: 2 * (3R + A) * 2G + 2 * G * (S + R) = 86,016
// FLOP per sample at the shipped widths (R 64, G 64, S 64, A 80) against
// 4 * (R + A + S + S + R) = 1,392 bytes moved in fp32: 62 FLOP per byte, above
// the fp32 FMA ridge (~20), so the fp32 FMA rate bounds it (0.62 ms per
// layer at T = 481,280 and 67 TFLOP/s).
//
// What the design does about that: both products run as fp32 FMA from
// shared memory with register tiles, for fp32 and bf16 inputs alike (bf16 is
// widened on load; the arithmetic is the plain version's). A block of 256
// threads owns 128 samples of one batch row:
//   1. gate [128 rows x 128 samples] = Wk [K x 128]^T . X [K x 128], with
//      K = 3R + A the rows of X = (x[t-d]; x[t]; x[t+d]; c[t]), streamed
//      through shared memory in 16-row chunks of Wk and of X (X's rows are
//      gathered from global memory at t - d, t, t + d, zero outside [0, T),
//      so no dilation needs a halo block and none is limited);
//   2. each thread owns rows {4ty..4ty+3} and {64+4ty..64+4ty+3} of gate --
//      the tanh half and the sigmoid half of the same 4 gate units -- so z
//      is formed in registers and written to shared memory [64 x 128];
//   3. [skip | out] [128 x 128] = Wso [64 x 128]^T . z, Wso streamed in
//      16-row chunks, then the epilogue adds the biases, the skip input and
//      the residual and writes skip' and x'.
// Each thread holds an 8 x 8 register tile, fed by two 16-byte shared loads
// per operand per k-step (4 FMAs per shared load). The weights are read from
// L2 through the chunks (43,008 floats, 168 KiB in all, packed by the
// wrapper: gate rows padded to 64 + 64, skip/out rows to 64 + 64, so any
// G, S, R <= 64 fits), never held whole. Shared memory: 8 KiB (weight chunk)
// + 8 KiB (X chunk) + 32 KiB (z) = 48 KiB, the static limit, so no
// cudaFuncSetAttribute is needed; registers, not shared memory, limit the
// blocks per SM (2 at the 128-register cap of __launch_bounds__(256, 2)).
// The TPU kernel's fixed block grid and D_HALO = 512 dilation limit have no
// counterpart here.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TT = 128;         // samples per block
constexpr int NO = 128;         // rows of both products: 64 + 64
constexpr int HALF = 64;        // max G, S and R
constexpr int KC = 16;          // rows per streamed chunk
constexpr int NUM_THREADS = 256;
constexpr int SMEM_BYTES = (KC * NO + KC * TT + HALF * TT) * 4;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Params {
  const void* x;       // [B, R, T]
  const void* c;       // [B, A, T], x's type
  const float* skip;   // [B, S, T]
  const float* wk;     // [3R + A, 128]: rows tap-major (t-d, t, t+d) then aux
  const float* bg;     // [128]
  const float* wso;    // [64, 128]: column j < 64 skip channel j, 64 + r out channel r
  const float* bso;    // [128]
  void* x_out;         // [B, R, T], x's type
  float* skip_out;     // [B, S, T]
  int R, A, S, len, d;
};

// Stage Wk/Wso rows [k0, k0 + KC) of `w` (rows of NO floats, `rows` in all)
__device__ __forceinline__ void stage_weights(float* ws, const float* __restrict__ w, int k0,
                                              int rows) {
  for (int e = threadIdx.x; e < KC * NO / 4; e += NUM_THREADS) {
    const int kk = e / (NO / 4), o4 = e % (NO / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 + kk < rows) v = reinterpret_cast<const float4*>(w + (long long)(k0 + kk) * NO)[o4];
    reinterpret_cast<float4*>(ws)[e] = v;
  }
}

// acc[i][j] += sum over the chunk's KC rows of a[k][row(i)] * b[k][col(j)],
// row(i) = 4ty + i (i < 4) or 64 + 4ty + i - 4; col(j) likewise with tx.
__device__ __forceinline__ void mma_chunk(float (&acc)[8][8], const float* as, const float* bs,
                                          int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    const float4 a0 = reinterpret_cast<const float4*>(as + kk * NO)[ty];
    const float4 a1 = reinterpret_cast<const float4*>(as + kk * NO)[16 + ty];
    const float4 b0 = reinterpret_cast<const float4*>(bs + kk * TT)[tx];
    const float4 b1 = reinterpret_cast<const float4*>(bs + kk * TT)[16 + tx];
    const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

__device__ __forceinline__ int tile_index(int i, int t4) {
  return i < 4 ? 4 * t4 + i : HALF + 4 * t4 + i - 4;
}

template <typename T>
__global__ void __launch_bounds__(NUM_THREADS, 2) wavenet_layer_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [KC][NO]
  float* xs = ws + KC * NO;                     // [KC][TT]
  float* zs = xs + KC * TT;                     // [HALF][TT]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.y, len = p.len, R = p.R;
  const long long t0 = (long long)blockIdx.x * TT;
  const T* xb = static_cast<const T*>(p.x) + (long long)b * R * len;
  const T* cb = static_cast<const T*>(p.c) + (long long)b * p.A * len;
  const int k_gate = 3 * R + p.A;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // 1. gate = Wk^T X
  for (int k0 = 0; k0 < k_gate; k0 += KC) {
    stage_weights(ws, p.wk, k0, k_gate);
    for (int e = threadIdx.x; e < KC * TT; e += NUM_THREADS) {
      const int kk = e / TT, tt = e % TT, k = k0 + kk;
      float v = 0.f;
      if (k < k_gate) {
        const T* src;
        long long t = t0 + tt;
        if (k < 3 * R) {
          src = xb + (long long)(k % R) * len;
          t += (long long)(k / R - 1) * p.d;
        } else {
          src = cb + (long long)(k - 3 * R) * len;
        }
        if (t >= 0 && t < len) v = to_float(src[t]);
      }
      xs[e] = v;
    }
    __syncthreads();
    mma_chunk(acc, ws, xs, tx, ty);
    __syncthreads();
  }

  // 2. z = tanh(gate a-half) * sigmoid(gate b-half), to shared memory
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = 4 * ty + i;
    const float ba = p.bg[g], bb = p.bg[HALF + g];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float za = tanhf(acc[i][j] + ba);
      const float zb = 1.0f / (1.0f + expf(-(acc[i + 4][j] + bb)));
      zs[g * TT + tile_index(j, tx)] = za * zb;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // 3. [skip | out] = Wso^T z
  for (int k0 = 0; k0 < HALF; k0 += KC) {
    stage_weights(ws, p.wso, k0, HALF);
    __syncthreads();  // also orders the z writes above before the first read
    mma_chunk(acc, ws, zs + k0 * TT, tx, ty);
    __syncthreads();
  }

  const float rsqrt2 = 0.70710678118654752f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ch = 4 * ty + (i & 3);  // skip channel (i < 4) or out channel (i >= 4)
    if (i < 4 ? ch >= p.S : ch >= R) continue;
    const float bias = p.bso[tile_index(i, ty)];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long t = t0 + tile_index(j, tx);
      if (t >= len) continue;
      if (i < 4) {
        const long long o = ((long long)b * p.S + ch) * len + t;
        p.skip_out[o] = p.skip[o] + (acc[i][j] + bias);
      } else {
        const long long o = ((long long)b * R + ch) * len + t;
        store(static_cast<T*>(p.x_out) + o,
              (acc[i][j] + bias + to_float(xb[(long long)ch * len + t])) * rsqrt2);
      }
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// shapes the kernel does not take, without launching).
extern "C" int vbt_fused_wavenet(const void* x, const void* c, const float* skip, const float* wk,
                                 const float* bg, const float* wso, const float* bso,
                                 void* x_out, float* skip_out, int B, int R, int A, int S, int T,
                                 int d, int is_bf16, void* stream) {
  const long long tiles = ((long long)T + TT - 1) / TT;
  if (B <= 0 || B > 65535 || T <= 0 || d < 1 || R < 1 || R > HALF || S < 1 || S > HALF ||
      A < 0 || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Params p{x, c, skip, wk, bg, wso, bso, x_out, skip_out, R, A, S, T, d};
  const dim3 grid((unsigned)tiles, (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    wavenet_layer_kernel<__nv_bfloat16><<<grid, NUM_THREADS, SMEM_BYTES, s>>>(p);
  else
    wavenet_layer_kernel<float><<<grid, NUM_THREADS, SMEM_BYTES, s>>>(p);
  return (int)cudaGetLastError();
}
