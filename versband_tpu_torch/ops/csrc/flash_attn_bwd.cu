// Flash-attention backward for Hopper (sm_90a): kernels K2 (dQ) and K3 (dK, dV).
//
// Replaces versband_tpu/ops/flash_attention.py::_dq_kernel (K2) and
// ::_dkv_kernel (K3), the two Pallas TPU kernels of _flash_bwd_impl. Same
// functions, with P recomputed from the forward's log-sum-exp and keys at
// index >= kv_len[b] contributing nothing:
//   P_ij  = exp(scale * q_i.k_j - lse_i)        (0 for masked keys)
//   dP_ij = dO_i.v_j,   dS_ij = P_ij (dP_ij - delta_i),   delta_i = dO_i.O_i
//   K2: dQ_i = scale * sum_j dS_ij k_j
//   K3: dV_j = sum_i P_ij dO_i,   dK_j = scale * sum_i dS_ij q_i
// delta is computed by the caller (fp32 PyTorch), as the JAX package leaves
// it to XLA. Two kernels and no atomics, so every gradient is a fixed-order
// sum: the result is deterministic run to run.
//
// What bounds them on the card: at the training shape (q/k/v/dO
// [8, 768, 8, 96] fp32) K2 is 6*B*H*Tq*Tk*D = 21.7 GFLOP against 95 MB moved
// (q, k, v, dO, lse, delta read, dq written) and K3 8*B*H*Tq*Tk*D = 29.0
// GFLOP against 114 MB, 230-255 FLOP per byte, far above the fp32 ridge of
// ~20: the fp32 FMA rate bounds them (0.32 ms and 0.43 ms at 67 TFLOP/s).
//
// What the design does about that: everything runs as fp32 FMA from shared
// memory, for both input types (bf16 inputs are widened on load, as the TPU
// kernels cast to fp32), so the arithmetic is the plain version's. A block
// of 256 threads owns one 64-row tile -- queries in K2, keys in K3 -- of one
// (b, h) and streams the other side through shared memory in 64-row tiles;
// its accumulators (dQ, or dK and dV) stay in registers across the stream.
// Each thread owns a 4-row x 4-column (scores) or 4-row x D/16-column
// (gradients) register tile of every product, so each pair of shared loads
// feeds 2 FMAs and the 64x64 score tiles never reach device memory. Tiles
// are stored row-major with an odd pitch (D + 1, 65), which makes both the
// row reads and the transposed column reads of q k^T, dO v^T, P^T dO and
// dS^T q free of bank conflicts. K3 reads P and dS transposed by computing
// the score tile transposed (keys as rows: S^T = K Q^T) in the first place.
// Ragged Tq/Tk edges and kv_len are masked in the kernel; P is set to 0
// before any use on masked entries, so the finite lse of a fully masked row
// never reaches exp. A tensor-core (mma.sync / wgmma) version is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 64;          // rows of the owned tile and of each streamed tile
constexpr int NUM_THREADS = 256;   // 16 x 16 threads
constexpr int RPT = 4;             // rows of a 64-row tile per thread (16 * 4 = 64)
constexpr int LDP = BLOCK + 1;     // pitch of the 64x64 score tiles in shared memory

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const int* kv_len;   // [B] or null (all Tk keys valid)
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  void* dq;            // [B, Tq, H, D] contiguous, I/O type
  void* dk;            // [B, Tk, H, D] contiguous
  void* dv;            // [B, Tk, H, D] contiguous
  int B, Tq, Tk, H;
  long long q_sb, q_st, q_sh;  // element strides over (B, T, H); D is unit-stride
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;  // dO
  float scale;
};

__device__ __forceinline__ int valid_keys(const Params& p, int b) {
  int n = p.kv_len ? p.kv_len[b] : p.Tk;
  return max(0, min(n, p.Tk));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + 64) of one (b, h) slice into shared memory as fp32,
// pitch D + 1; rows at or past `nrows` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int row0, int nrows) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < BLOCK * D; i += NUM_THREADS) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[r * LD + c] = row < nrows ? to_f32(src[(long long)row * row_stride + c]) : 0.f;
  }
}

// The 64 row statistics (lse, delta) of query rows [row0, row0 + 64); 0 past Tq.
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s, const Params& p,
                                           int b, int h, int row0) {
  if (threadIdx.x < BLOCK) {
    const int row = row0 + threadIdx.x;
    const long long idx = ((long long)b * p.H + h) * p.Tq + row;
    lse_s[threadIdx.x] = row < p.Tq ? p.lse[idx] : 0.f;
    delta_s[threadIdx.x] = row < p.Tq ? p.delta[idx] : 0.f;
  }
}

// acc[i][j] += sum_kk A[r0 + i][kk] * B[kk][tx + 16 j] for this thread's
// 4 rows and NJ columns, with A and B read through compile-time strides.
template <int K, int NJ, int A_RS, int A_CS, int B_RS, int B_CS>
__device__ __forceinline__ void tile_product(float (&acc)[RPT][NJ], const float* A,
                                             const float* B, int r0, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float a[RPT], bv[NJ];
#pragma unroll
    for (int i = 0; i < RPT; ++i) a[i] = A[(r0 + i) * A_RS + kk * A_CS];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = B[kk * B_RS + (tx + 16 * j) * B_CS];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

template <int D>
constexpr int smem_floats_dq() {
  return 4 * BLOCK * (D + 1) + BLOCK * LDP + 2 * BLOCK;
}

template <int D>
constexpr int smem_floats_dkv() {
  return 4 * BLOCK * (D + 1) + 2 * BLOCK * LDP + 2 * BLOCK;
}

// ---------------------------------------------------------------- K2: dQ

template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dq(Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                   // [64][LD] this block's query rows
  float* dOs = Qs + BLOCK * LD;       // [64][LD]
  float* Ks = dOs + BLOCK * LD;       // [64][LD] streamed keys
  float* Vs = Ks + BLOCK * LD;        // [64][LD]
  float* dSs = Vs + BLOCK * LD;       // [64][LDP] dS of the current key tile
  float* lse_s = dSs + BLOCK * LDP;   // [64]
  float* delta_s = lse_s + BLOCK;     // [64]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BLOCK;
  const int tx = threadIdx.x % 16, r0 = (threadIdx.x / 16) * RPT;
  const int kv_len = valid_keys(p, b);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* og = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;

  load_tile<T, D>(Qs, qg, p.q_st, q0, p.Tq);
  load_tile<T, D>(dOs, og, p.o_st, q0, p.Tq);
  load_stats(lse_s, delta_s, p, b, h, q0);

  float acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < kv_len; n0 += BLOCK) {
    __syncthreads();  // the previous K/V/dS tile is consumed (and Q/dO/stats are in)
    load_tile<T, D>(Ks, kg, p.k_st, n0, p.Tk);
    load_tile<T, D>(Vs, vg, p.v_st, n0, p.Tk);
    __syncthreads();

    float s[RPT][4], dp[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_product<D, 4, LD, 1, 1, LD>(s, Qs, Ks, r0, tx);    // S  = Q K^T
    tile_product<D, 4, LD, 1, 1, LD>(dp, dOs, Vs, r0, tx);  // dP = dO V^T
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float pij = n0 + c < kv_len ? expf(s[i][j] * p.scale - lse_s[r]) : 0.f;
        dSs[r * LDP + c] = pij * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    tile_product<BLOCK, NJ, LDP, 1, LD, 1>(acc, dSs, Ks, r0, tx);  // dQ += dS K
  }

  T* dqg = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + r0 + i;
    if (row >= p.Tq) continue;
    T* dst = dqg + (((long long)b * p.Tq + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dst[tx + 16 * j] = from_f32<T>(acc[i][j] * p.scale);
  }
}

// ---------------------------------------------------------------- K3: dK, dV

template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dkv(Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                   // [64][LD] this block's keys
  float* Vs = Ks + BLOCK * LD;        // [64][LD]
  float* Qs = Vs + BLOCK * LD;        // [64][LD] streamed query rows
  float* dOs = Qs + BLOCK * LD;       // [64][LD]
  float* PTs = dOs + BLOCK * LD;      // [64 keys][LDP] P^T of the current query tile
  float* dSTs = PTs + BLOCK * LDP;    // [64 keys][LDP] dS^T
  float* lse_s = dSTs + BLOCK * LDP;  // [64]
  float* delta_s = lse_s + BLOCK;     // [64]

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BLOCK;
  const int tx = threadIdx.x % 16, r0 = (threadIdx.x / 16) * RPT;
  const int kv_len = valid_keys(p, b);

  float dk[RPT][NJ], dv[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  if (k0 < kv_len) {  // key tiles wholly past kv_len have zero gradients
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
    const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
    const T* og = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
    load_tile<T, D>(Ks, kg, p.k_st, k0, p.Tk);
    load_tile<T, D>(Vs, vg, p.v_st, k0, p.Tk);

    for (int m0 = 0; m0 < p.Tq; m0 += BLOCK) {
      __syncthreads();  // the previous Q/dO/P/dS tiles are consumed
      load_tile<T, D>(Qs, qg, p.q_st, m0, p.Tq);
      load_tile<T, D>(dOs, og, p.o_st, m0, p.Tq);
      load_stats(lse_s, delta_s, p, b, h, m0);
      __syncthreads();

      float st[RPT][4], dpt[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
      tile_product<D, 4, LD, 1, 1, LD>(st, Ks, Qs, r0, tx);    // S^T  = K Q^T
      tile_product<D, 4, LD, 1, 1, LD>(dpt, Vs, dOs, r0, tx);  // dP^T = V dO^T
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = r0 + i;
        const bool key_ok = k0 + r < kv_len;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float pij =
              key_ok && m0 + c < p.Tq ? expf(st[i][j] * p.scale - lse_s[c]) : 0.f;
          PTs[r * LDP + c] = pij;
          dSTs[r * LDP + c] = pij * (dpt[i][j] - delta_s[c]);
        }
      }
      __syncthreads();
      tile_product<BLOCK, NJ, LDP, 1, LD, 1>(dv, PTs, dOs, r0, tx);  // dV += P^T dO
      tile_product<BLOCK, NJ, LDP, 1, LD, 1>(dk, dSTs, Qs, r0, tx);  // dK += dS^T Q
    }
  }

  T* dkg = static_cast<T*>(p.dk);
  T* dvg = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = k0 + r0 + i;
    if (row >= p.Tk) continue;
    const long long off = (((long long)b * p.Tk + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkg[off + tx + 16 * j] = from_f32<T>(dk[i][j] * p.scale);
      dvg[off + tx + 16 * j] = from_f32<T>(dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename KernelT>
cudaError_t launch(KernelT kernel, int smem_floats, int rows, const Params& p,
                   cudaStream_t stream) {
  const int smem = smem_floats * (int)sizeof(float);
  // Above 48 KB a kernel needs the cap raised (per kernel, cheap to repeat).
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + BLOCK - 1) / BLOCK, p.H, p.B);
  kernel<<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();  // a refused launch (resources) shows here, not at a sync
}

template <int D>
cudaError_t dispatch_dq(const Params& p, int is_bf16, cudaStream_t s) {
  if (is_bf16) return launch(flash_bwd_dq<__nv_bfloat16, D>, smem_floats_dq<D>(), p.Tq, p, s);
  return launch(flash_bwd_dq<float, D>, smem_floats_dq<D>(), p.Tq, p, s);
}

template <int D>
cudaError_t dispatch_dkv(const Params& p, int is_bf16, cudaStream_t s) {
  if (is_bf16)
    return launch(flash_bwd_dkv<__nv_bfloat16, D>, smem_floats_dkv<D>(), p.Tk, p, s);
  return launch(flash_bwd_dkv<float, D>, smem_floats_dkv<D>(), p.Tk, p, s);
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const int* kv_len, const float* lse, const float* delta, void* dq,
                   void* dk, void* dv, int B, int Tq, int Tk, int H, const long long* st,
                   float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.kv_len = kv_len;
  p.lse = lse; p.delta = delta; p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.Tq = Tq; p.Tk = Tk; p.H = H;
  p.q_sb = st[0]; p.q_st = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_st = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_st = st[7]; p.v_sh = st[8];
  p.o_sb = st[9]; p.o_st = st[10]; p.o_sh = st[11];
  p.scale = scale;
  return p;
}

}  // namespace

// Both entry points return 0 on success, else the CUDA error of the launch.
// The wrapper (versband_tpu_torch/ops/flash_attention.py) checks shapes,
// types and strides before calling. `strides` holds the 12 element strides
// (b, t, h) of q, k, v and dO in that order; D must be 32, 64, 96 or 128.
extern "C" int vbt_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const int* kv_len, const float* lse,
                                     const float* delta, void* dq, int B, int Tq, int Tk,
                                     int H, int D, const long long* strides, float scale,
                                     int is_bf16, void* stream) {
  const Params p = make_params(q, k, v, dout, kv_len, lse, delta, dq, nullptr, nullptr, B, Tq,
                               Tk, H, strides, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)dispatch_dq<32>(p, is_bf16, s);
    case 64: return (int)dispatch_dq<64>(p, is_bf16, s);
    case 96: return (int)dispatch_dq<96>(p, is_bf16, s);
    case 128: return (int)dispatch_dq<128>(p, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int vbt_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const int* kv_len, const float* lse,
                                      const float* delta, void* dk, void* dv, int B, int Tq,
                                      int Tk, int H, int D, const long long* strides,
                                      float scale, int is_bf16, void* stream) {
  const Params p = make_params(q, k, v, dout, kv_len, lse, delta, nullptr, dk, dv, B, Tq, Tk,
                               H, strides, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)dispatch_dkv<32>(p, is_bf16, s);
    case 64: return (int)dispatch_dkv<64>(p, is_bf16, s);
    case 96: return (int)dispatch_dkv<96>(p, is_bf16, s);
    case 128: return (int)dispatch_dkv<128>(p, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
