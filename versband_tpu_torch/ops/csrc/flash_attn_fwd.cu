// Flash-attention forward for Hopper (sm_90a): kernel K1 of the port.
//
// Replaces versband_tpu/ops/flash_attention.py::_attn_kernel (the Pallas TPU
// kernel launched by _flash_fwd_impl). Same function: out = softmax(scale *
// q k^T) v per (batch, head), keys at index >= kv_len[b] masked out, rows
// with kv_len == 0 written as 0, and the per-row log-sum-exp
// lse = m + log(max(l, 1e-30)) in float32, finite even for fully masked rows.
// Logits, softmax statistics and the output accumulator are float32 whatever
// the I/O type.
//
// What bounds it on the card: at the serving shape (q/k/v [2, 752, 8, 96]
// bf16, unmasked) one launch is 4*B*H*T^2*D = 3.47 GFLOP against 2.3 MB of
// q/k/v/out, about 1,500 FLOP per byte, far above the H100's ~295 FLOP/B
// ridge: the tensor cores bound it (3.5 us at 989 TFLOP/s bf16), not memory.
//
// What the design does about that: the bf16 path runs both products (q k^T
// and p v) on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
// accumulate). The scores never leave registers: the S accumulator fragment
// is re-packed in place as the A operand of the P.V product (the FA2 layout
// trick), so the T x T matrix never touches shared or device memory. A block
// owns one 64-row query tile of one (b, h): 4 warps x 16 rows, 2*8*12 = 192
// blocks at the serving shape for 132 SMs. K and V stream through shared
// memory in 64-key tiles; the loop stops at the last tile holding a valid
// key. q/k/v are read in their [B, T, H, D] layout through strides (no
// transpose or pad copies); ragged Tq/Tk edges are masked in the kernel.
// The probabilities are rounded to bf16 for the P.V product (the reference
// keeps them in fp32); that costs ~2^-9 relative error per term, well inside
// the bf16 output rounding. The fp32 path is a plain FMA kernel (two threads
// per query row) that keeps every product in fp32. A wgmma/TMA pipeline is
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;     // query rows per block
constexpr int BLOCK_N = 64;     // keys per shared-memory tile
constexpr int NUM_THREADS = 128;
constexpr float NEG_BIG = -3.4028234663852886e38f;  // float32 min, as the reference

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;  // [B] or null (all Tk keys valid)
  void* out;          // [B, Tq, H, D] contiguous, I/O type
  float* lse;         // [B, H, Tq] contiguous
  int B, Tq, Tk, H;
  long long q_sb, q_st, q_sh;  // element strides of q over (B, T, H); D is unit-stride
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  float scale;
};

__device__ __forceinline__ int valid_keys(const Params& p, int b) {
  int n = p.kv_len ? p.kv_len[b] : p.Tk;
  return max(0, min(n, p.Tk));
}

// ---------------------------------------------------------------- bf16 path

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 t;
  t.x = lo;
  t.y = hi;
  return *reinterpret_cast<uint32_t*>(&t);
}

// Copy rows [row0, row0 + ROWS) of one (b, h) slice into shared memory with
// 16-byte loads; rows at or past `nrows` are zero-filled.
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long row_stride, int row0, int nrows) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NUM_THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

template <int D>
constexpr int smem_bytes_bf16() {
  return 3 * BLOCK_M * (D + 8) * (int)sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS) flash_fwd_bf16(Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(BLOCK_M == BLOCK_N, "shared layout assumes square tiles");
  constexpr int LD = D + 8;  // row pitch in elements: 16-B aligned, staggers banks
  constexpr int KD = D / 16;       // k-steps of q k^T
  constexpr int NT = BLOCK_N / 8;  // 8-key column tiles of S
  constexpr int DT = D / 8;        // 8-wide column tiles of O

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BLOCK_M * LD;
  __nv_bfloat16* Vs = Ks + BLOCK_N * LD;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BLOCK_M;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column pair
  const int kv_len = valid_keys(p, b);

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile_bf16<D, BLOCK_M, LD>(Qs, qg, p.q_st, q0, p.Tq);
  __syncthreads();

  // This warp's 16 query rows as A fragments, kept in registers throughout.
  uint32_t qf[KD][4];
  {
    const __nv_bfloat16* qw = Qs + (warp * 16) * LD;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const __nv_bfloat16* base = qw + kk * 16 + t4 * 2;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(base + g * LD);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * LD);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + g * LD + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * LD + 8);
    }
  }

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  // Each thread holds rows g (index 0) and g + 8 (index 1) of its warp's 16.
  float m_run[2] = {NEG_BIG, NEG_BIG};
  float l_run[2] = {0.f, 0.f};  // this thread's partial row sums

  for (int n0 = 0; n0 < kv_len; n0 += BLOCK_N) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D, BLOCK_N, LD>(Ks, kg, p.k_st, n0, p.Tk);
    load_tile_bf16<D, BLOCK_N, LD>(Vs, vg, p.v_st, n0, p.Tk);
    __syncthreads();

    // S = q k^T for 16 rows x 64 keys, fp32 accumulators.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kb = Ks + (nt * 8 + g) * LD + t4 * 2;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kb + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kb + kk * 16 + 8);
        mma_16816(s[nt], qf[kk], b0, b1);
      }
    }

    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = n0 + nt * 8 + t4 * 2 + (r & 1);
        const float val = col < kv_len ? s[nt][r] * p.scale : NEG_BIG;
        s[nt][r] = val;
        mx[r >> 1] = fmaxf(mx[r >> 1], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // a row's 64 scores live in the 4 lanes of a quad
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = expf(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = expf(s[nt][r] - m_run[r >> 1]);
        s[nt][r] = e;
        l_run[r >> 1] += e;
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V. The S fragments of key tiles 2j and 2j+1 form the A operand
    // of k-step j; B is V[key][d] read column-wise from shared memory.
#pragma unroll
    for (int j = 0; j < BLOCK_N / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const __nv_bfloat16* vb = Vs + (j * 16 + t4 * 2) * LD + g;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* col = vb + dt * 8;
        const uint32_t b0 = pack_bf16(col[0], col[LD]);
        const uint32_t b1 = pack_bf16(col[8 * LD], col[9 * LD]);
        mma_16816(o[dt], a, b0, b1);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    const float l = fmaxf(l_run[i], 1e-30f);
    inv[i] = 1.f / l;
    const int row = q0 + warp * 16 + g + 8 * i;
    if (t4 == 0 && row < p.Tq)
      p.lse[((long long)b * p.H + h) * p.Tq + row] = m_run[i] + logf(l);
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= p.Tq) continue;
    __nv_bfloat16* orow = og + (((long long)b * p.Tq + row) * p.H + h) * D + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_bf16(o[dt][2 * i] * inv[i], o[dt][2 * i + 1] * inv[i]);
  }
}

// ---------------------------------------------------------------- fp32 path

template <int D>
constexpr int smem_bytes_f32() {
  return 2 * BLOCK_N * D * (int)sizeof(float);
}

template <int D, int ROWS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long row_stride,
                                              int row0, int nrows) {
  constexpr int CHUNKS = D / 4;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NUM_THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * row_stride + c * 4);
    *reinterpret_cast<float4*>(dst + r * D + c * 4) = val;
  }
}

// Two threads per query row, each owning half of the head dim; the two
// halves of a dot product meet through one shuffle.
template <int D>
__global__ void __launch_bounds__(NUM_THREADS) flash_fwd_f32(Params p) {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  static_assert(NUM_THREADS == 2 * BLOCK_M, "two threads per query row");
  constexpr int HD = D / 2;
  constexpr int CHUNK = 16;  // scores held in registers at a time

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + BLOCK_N * D;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BLOCK_M;
  const int row = q0 + threadIdx.x / 2, half = threadIdx.x & 1;
  const int kv_len = valid_keys(p, b);

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  float q[HD], acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) {
    q[i] = row < p.Tq ? qg[(long long)row * p.q_st + half * HD + i] * p.scale : 0.f;
    acc[i] = 0.f;
  }
  float m_run = NEG_BIG, l_run = 0.f;

  for (int n0 = 0; n0 < kv_len; n0 += BLOCK_N) {
    __syncthreads();
    load_tile_f32<D, BLOCK_N>(Ks, kg, p.k_st, n0, p.Tk);
    load_tile_f32<D, BLOCK_N>(Vs, vg, p.v_st, n0, p.Tk);
    __syncthreads();
    for (int c0 = 0; c0 < BLOCK_N && n0 + c0 < kv_len; c0 += CHUNK) {
      float s[CHUNK];
      float mx = NEG_BIG;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const float* kr = Ks + (c0 + j) * D + half * HD;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < HD; ++i) part = fmaf(q[i], kr[i], part);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        s[j] = n0 + c0 + j < kv_len ? part : NEG_BIG;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);
      m_run = m_new;
      l_run *= alpha;
#pragma unroll
      for (int i = 0; i < HD; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const float e = expf(s[j] - m_new);
        l_run += e;
        const float* vr = Vs + (c0 + j) * D + half * HD;
#pragma unroll
        for (int i = 0; i < HD; ++i) acc[i] = fmaf(e, vr[i], acc[i]);
      }
    }
  }

  if (row >= p.Tq) return;
  const float l = fmaxf(l_run, 1e-30f);
  float* orow = static_cast<float*>(p.out) + (((long long)b * p.Tq + row) * p.H + h) * D + half * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) orow[i] = acc[i] / l;
  if (half == 0) p.lse[((long long)b * p.H + h) * p.Tq + row] = m_run + logf(l);
}

// ---------------------------------------------------------------- launch

template <typename KernelT>
cudaError_t launch(KernelT kernel, int smem, const Params& p, cudaStream_t stream) {
  // Raising the dynamic shared-memory cap is per kernel and per device; it is
  // cheap, so it is set on every launch rather than cached.
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + BLOCK_M - 1) / BLOCK_M, p.H, p.B);
  kernel<<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const Params& p, int is_bf16, cudaStream_t stream) {
  if (is_bf16) return launch(flash_fwd_bf16<D>, smem_bytes_bf16<D>(), p, stream);
  return launch(flash_fwd_f32<D>, smem_bytes_f32<D>(), p, stream);
}

}  // namespace

// Returns 0 on success, else the CUDA error of the launch. The wrapper
// (versband_tpu_torch/ops/flash_attention.py) checks shapes, types, strides
// and alignment before calling; D must be 32, 64, 96 or 128.
extern "C" int vbt_flash_attn_fwd(const void* q, const void* k, const void* v, const int* kv_len,
                                  void* out, float* lse, int B, int Tq, int Tk, int H, int D,
                                  long long q_sb, long long q_st, long long q_sh, long long k_sb,
                                  long long k_st, long long k_sh, long long v_sb, long long v_st,
                                  long long v_sh, float scale, int is_bf16, void* stream) {
  Params p{q,    k,    v,    kv_len, out,  lse,  B,    Tq,   Tk,   H,    q_sb, q_st,
           q_sh, k_sb, k_st, k_sh,   v_sb, v_st, v_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)dispatch<32>(p, is_bf16, s);
    case 64: return (int)dispatch<64>(p, is_bf16, s);
    case 96: return (int)dispatch<96>(p, is_bf16, s);
    case 128: return (int)dispatch<128>(p, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
