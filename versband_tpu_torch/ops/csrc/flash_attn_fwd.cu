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
// q/k/v/out, about 1,500 FLOP per byte: the tensor cores bound it (3.5 us at
// 989 TFLOP/s bf16, 5.4 us at the 644 TFLOP/s that mma.sync reaches on an
// H100), not memory. The fp32 training shape [8, 768, 8, 96] is 14.5 GFLOP,
// 88 us as three TF32 passes at 495 / 3 TFLOP/s.
//
// What the design does about that: both products (S = q k^T and O += P v)
// run on the tensor cores through mma.sync with fp32 accumulators.
// * bf16 inputs: m16n8k16 bf16. q's A fragments come by ldmatrix.x4 at every
//   key tile (held in registers they would cost 48 at D = 96 with two
//   m-tiles, and spill), K's B fragments by ldmatrix.x4, V's by
//   ldmatrix.x4.trans. P is rounded to bf16
//   for P v, as before.
// * fp32 inputs: three m16n8k8 TF32 passes per product over operands split
//   into a TF32 head (cvt.rna) and a tail (the exact rest): tail.head +
//   head.tail + head.head, 2^-21 of a term dropped, fp32-accurate (the scheme
//   of flash_attn_bwd.cu). q is split once per block into a head tile and a
//   tail tile in shared memory and read back by ldmatrix. The tensor core adds
//   into its accumulator with truncation, so the score's small terms are
//   summed apart from the head.head chain, and each key tile's P v is summed
//   from zero and added in fp32 to the rescaled running O (o = o alpha + pv).
//   P is split in registers and re-packed as the A operand with the slot
//   permutation of K2 (k-slot t is key 2t, slot t + 4 key 2t + 1), and V's B
//   operand is fetched with the same permutation.
// * The scores never leave registers: the accumulator fragment of S becomes
//   the A operand of P v after exp. The softmax runs in log2 units (logits
//   times scale * log2 e, ex2.approx); lse is converted back at the end.
// * K and V stream through a ring of 16-byte cp.async copies (zero-filled
//   past the last row), one barrier per tile: the next tile's copies fly
//   while this one is multiplied. Rows are padded by 16 bytes, so the pitch is an
//   odd number of 16-byte units and ldmatrix and the permuted scalar loads
//   are free of bank conflicts.
// * Block shape (Cfg): 128 query rows, WARPS warps of MT 16-row m-tiles
//   each; a warp's m-tiles share every K and V fragment it loads. Every
//   block reads all of K and V of its (b, h) from L2, so 128-row blocks move
//   half the traffic of 64-row ones.
//   - bf16: 4 warps x 2 m-tiles, 64-key tiles, 2 stages; 79,872 B of
//     shared memory at D = 96, one block per SM.
//   - fp32: 8 warps x 1 m-tile, 32-key tiles, 2 stages; 153,600 B (q's head
//     and tail, then the ring) at D = 96, one block per SM.
// q/k/v are read in their [B, T, H, D] layout through strides; ragged Tq/Tk
// edges are masked in the kernel; every row must start on a 16-byte boundary
// (the wrapper copies an input whose rows do not). No atomics: reruns are
// bit-equal.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr float NEG_BIG = -3.4028234663852886e38f;  // float32 min, as the reference
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

// Block shape and shared-memory layout of one (type, head dim).
template <typename T, int D>
struct Cfg {
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int MT = BF16 ? 2 : 1;    // 16-row m-tiles a warp
  static constexpr int WARPS = BF16 ? 4 : 8;
  static constexpr int BN = BF16 ? 64 : 32;  // keys per streamed tile
  // stages of the K/V ring: a third spills the bf16 kernel at D = 96
  static constexpr int STAGES = 2;
  static constexpr int BM = 16 * MT * WARPS;  // query rows per block
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int VEC = 16 / (int)sizeof(T);         // elements per 16 bytes
  static constexpr int LD = D + VEC;                      // row pitch in elements
  static constexpr int PITCH = LD * (int)sizeof(T);       // row pitch in bytes
  static constexpr int KSTEPS = D * (int)sizeof(T) / 32;  // mma k-steps over D (32 bytes each)
  static constexpr int NT = BN / 8;                       // 8-key column tiles of S
  static constexpr int DT = D / 8;                        // 8-wide column tiles of O
  // k-steps of the fp32 score product unrolled together (a full unroll makes
  // ptxas hoist loads until it spills, as in K2/K3)
  static constexpr int K_UNROLL = BF16 ? KSTEPS : 2;
  static constexpr int Q_BYTES = (BF16 ? 1 : 2) * BM * PITCH;  // q, or its TF32 head and tail
  static constexpr int STAGE_BYTES = BN * PITCH;  // one K or V tile
  static constexpr int SMEM_BYTES = Q_BYTES + 2 * STAGES * STAGE_BYTES;  // q, the K/V ring
  static_assert(BN % 16 == 0, "a key tile is whole k-steps of P v");
  static_assert((PITCH / 16) % 2 == 1, "pitch must be an odd number of 16-byte units");
};

__device__ __forceinline__ int valid_keys(const Params& p, int b) {
  int n = p.kv_len ? p.kv_len[b] : p.Tk;
  return max(0, min(n, p.Tk));
}

// Rows [row0, row0 + ROWS) of one (b, h) slice into a shared-memory tile of
// pitch Cfg::PITCH by cp.async, by the whole block; rows at or past `nrows`
// are zero-filled. A power-of-two group of threads takes a row, so each
// thread keeps its column and steps its pointers by whole rows.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const T* src, long long row_stride,
                                          int row0, int nrows) {
  using C = Cfg<T, D>;
  constexpr int CHUNKS = D / C::VEC;  // 16-byte chunks per row
  constexpr int GROUP = CHUNKS <= 4 ? 4 : CHUNKS <= 8 ? 8 : CHUNKS <= 16 ? 16 : 32;
  static_assert(C::THREADS % GROUP == 0, "whole rows per pass");
  constexpr int PASS = C::THREADS / GROUP;  // rows per pass over the tile
  const int c = threadIdx.x % GROUP, r0 = threadIdx.x / GROUP;
  if (c >= CHUNKS) return;
  const T* from = src + (long long)(row0 + r0) * row_stride + c * C::VEC;
  uint32_t to = dst + r0 * C::PITCH + c * 16;
#pragma unroll
  for (int r = r0; r < ROWS; r += PASS) {
    const bool ok = row0 + r < nrows;
    cp_async_16(to, ok ? from : src, ok ? 16 : 0);
    from += PASS * row_stride;
    to += PASS * C::PITCH;
  }
}

// 2^x by the special-function unit, results below 2^-126 flushed to 0 (a
// probability that small is nothing beside the row's largest, which is 1);
// exp2f adds a rescaling around the same instruction for subnormal results.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}

// One block per SM is all the launch bounds promise: without the minimum,
// ptxas caps the fp32 kernels at 128 registers, and they run slower.
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::THREADS, 1) flash_fwd(Params p) {
  using C = Cfg<T, D>;
  constexpr int MT = C::MT;
  extern __shared__ __align__(16) unsigned char smem[];
  // q (fp32: its TF32 head, then its tail); then a ring of STAGES stages of
  // K [BN] and V [BN]
  unsigned char* ring = smem + C::Q_BYTES;
  const uint32_t q_s = smem_u32(smem);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * C::BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column pair
  const int kv_len = valid_keys(p, b);
  const int n_tiles = (kv_len + C::BN - 1) / C::BN;  // key tiles up to the last valid key

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_rows<T, D, C::BM>(q_s, qg, p.q_st, q0, p.Tq);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {  // one commit group per stage, empty or not
    if (s < n_tiles) {
      const uint32_t st = smem_u32(ring) + s * 2 * C::STAGE_BYTES;
      load_rows<T, D, C::BN>(st, kg, p.k_st, s * C::BN, p.Tk);
      load_rows<T, D, C::BN>(st + C::STAGE_BYTES, vg, p.v_st, s * C::BN, p.Tk);
    }
    cp_async_commit();
  }
  cp_async_wait<C::STAGES - 1>();  // q has landed (the first K/V tiles may still fly)
  __syncthreads();

  // A warp owns MT tiles of 16 query rows, rows (warp MT + mt) 16 + [0, 16).
  // This lane's ldmatrix row addresses: `a_off` into q for m-tile 0 (rows
  // lane % 16, second 16 bytes of a k-step for lanes 16-31; m-tile mt is
  // 16 mt rows further); `b_off` into a K tile (matrices: keys 0-7 k lo,
  // keys 0-7 k hi, keys 8-15 k lo, keys 8-15 k hi).
  const uint32_t a_off = (warp * MT * 16 + (lane & 15)) * C::PITCH + (lane >> 4) * 16;
  const uint32_t b_off = (((lane >> 4) << 3) + (lane & 7)) * C::PITCH + ((lane >> 3) & 1) * 16;

  if constexpr (!C::BF16) {  // q split once into its TF32 head (in place) and tail
    float* qh = reinterpret_cast<float*>(smem);
    float* qt = qh + C::BM * C::LD;
    for (int i = threadIdx.x; i < C::BM * D; i += C::THREADS) {
      const int at = (i / D) * C::LD + i % D;
      uint32_t hd, tl;
      split_tf32(qh[at], hd, tl);
      qh[at] = __uint_as_float(hd);
      qt[at] = __uint_as_float(tl);
    }
    __syncthreads();
  }

  float o[MT][C::DT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) zero(o[mt]);
  // Each thread holds rows g (index 0) and g + 8 (index 1) of each m-tile.
  float m2[MT][2], l[MT][2];  // running max of the log2-scaled logits; partial row sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) m2[mt][0] = m2[mt][1] = NEG_BIG, l[mt][0] = l[mt][1] = 0.f;
  const float scale_log2 = p.scale * LOG2E;

  // S = q k^T of key tile `tile`: MT x 16 rows x BN keys; each K fragment
  // serves every m-tile
  auto scores = [&](float (&s)[MT][C::NT][4], int tile) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) zero(s[mt]);
    const uint32_t kb = smem_u32(ring) + (tile % C::STAGES) * 2 * C::STAGE_BYTES + b_off;
    if constexpr (C::BF16) {
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) {
        uint32_t qk[MT][4];  // q's A fragments, read again for every key tile
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(qk[mt], q_s + a_off + mt * 16 * C::PITCH + kk * 32);
#pragma unroll
        for (int np = 0; np < C::NT / 2; ++np) {  // two 8-key tiles per ldmatrix
          uint32_t x[4];
          ldmatrix_x4(x, kb + np * 16 * C::PITCH + kk * 32);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * np], qk[mt], x[0], x[1]);
            mma_bf16(s[mt][2 * np + 1], qk[mt], x[2], x[3]);
          }
        }
      }
    } else {
      float small[MT][C::NT][4];  // tail.head + head.tail, summed apart from head.head
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) zero(small[mt]);
#pragma unroll C::K_UNROLL
      for (int kk = 0; kk < C::KSTEPS; ++kk) {
        AFrag a[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t at = q_s + a_off + mt * 16 * C::PITCH + kk * 32;
          ldmatrix_x4(a[mt].head, at);
          ldmatrix_x4(a[mt].tail, at + C::BM * C::PITCH);
        }
#pragma unroll
        for (int np = 0; np < C::NT / 2; ++np) {
          uint32_t x[4];
          ldmatrix_x4(x, kb + np * 16 * C::PITCH + kk * 32);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_step<false>(s[mt][2 * np], small[mt][2 * np], a[mt], x[0], x[1]);
            mma_step<false>(s[mt][2 * np + 1], small[mt][2 * np + 1], a[mt], x[2], x[3]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) s[mt][nt][r] += small[mt][nt][r];
    }
  };
  // the online softmax of key tile `tile` in log2 units: S becomes P, alpha
  // the factor of the old row sums; keys at or past kv_len only in the last tile
  auto softmax = [&](float (&s)[MT][C::NT][4], int tile, float (&alpha)[MT][2]) {
    const int n0 = tile * C::BN;
    const bool ragged = n0 + C::BN > kv_len;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[mt][nt][r] *= scale_log2;
      if (ragged) {
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (n0 + nt * 8 + t4 * 2 + (r & 1) >= kv_len) s[mt][nt][r] = NEG_BIG;
      }
      float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) mx[r >> 1] = fmaxf(mx[r >> 1], s[mt][nt][r]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // a row's BN scores live in the 4 lanes of a quad
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m2[mt][i], mx[i]);
        alpha[mt][i] = exp2_ftz(m2[mt][i] - m_new);
        m2[mt][i] = m_new;
        l[mt][i] *= alpha[mt][i];
      }
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float e = exp2_ftz(s[mt][nt][r] - m2[mt][r >> 1]);
          s[mt][nt][r] = e;
          l[mt][r >> 1] += e;
        }
      }
    }
  };
  // O = O alpha + P V for key tile `tile`; each V fragment serves every m-tile
  auto pv = [&](const float (&s)[MT][C::NT][4], int tile, const float (&alpha)[MT][2]) {
    const unsigned char* v_t = ring + (tile % C::STAGES) * 2 * C::STAGE_BYTES + C::STAGE_BYTES;
    if constexpr (C::BF16) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int dt = 0; dt < C::DT; ++dt)
#pragma unroll
          for (int r = 0; r < 4; ++r) o[mt][dt][r] *= alpha[mt][r >> 1];
      // ldmatrix.trans: matrices (keys 0-7 | 8-15 of the k-step) x (dims 0-7 | 8-15)
      const uint32_t vb = smem_u32(v_t) +
                          ((((lane >> 3) & 1) << 3) + (lane & 7)) * C::PITCH + (lane >> 4) * 16;
#pragma unroll
      for (int j = 0; j < C::BN / 16; ++j) {  // 8-key tiles 2j, 2j+1 make k-step j's A
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a[mt][0] = pack_bf16(s[mt][2 * j][0], s[mt][2 * j][1]);
          a[mt][1] = pack_bf16(s[mt][2 * j][2], s[mt][2 * j][3]);
          a[mt][2] = pack_bf16(s[mt][2 * j + 1][0], s[mt][2 * j + 1][1]);
          a[mt][3] = pack_bf16(s[mt][2 * j + 1][2], s[mt][2 * j + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t x[4];
          ldmatrix_x4_trans(x, vb + j * 16 * C::PITCH + dp * 32);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][2 * dp], a[mt], x[0], x[1]);
            mma_bf16(o[mt][2 * dp + 1], a[mt], x[2], x[3]);
          }
        }
      }
    } else {
      // k-slot t4 is key 2 t4 of the 8-key tile, slot t4 + 4 is key 2 t4 + 1
      const float* vb = reinterpret_cast<const float*>(v_t) + 2 * t4 * C::LD + g;
      AFrag a[MT][C::NT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
          const float(&f)[4] = s[mt][nt];
          split_tf32(f[0], a[mt][nt].head[0], a[mt][nt].tail[0]);  // (g,     2 t4) -> slot t4
          split_tf32(f[2], a[mt][nt].head[1], a[mt][nt].tail[1]);  // (g + 8, 2 t4)
          split_tf32(f[1], a[mt][nt].head[2], a[mt][nt].tail[2]);  // (g, 2 t4 + 1) -> slot t4 + 4
          split_tf32(f[3], a[mt][nt].head[3], a[mt][nt].tail[3]);  // (g + 8, 2 t4 + 1)
        }
      // this tile's share is summed from zero and added in fp32: the tensor
      // core's truncating adds see only the BN-long chain
#pragma unroll
      for (int dt = 0; dt < C::DT; ++dt) {
        float t[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) t[mt][0] = t[mt][1] = t[mt][2] = t[mt][3] = 0.f;
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
          const uint32_t b0 = __float_as_uint(vb[nt * 8 * C::LD + dt * 8]);
          const uint32_t b1 = __float_as_uint(vb[nt * 8 * C::LD + C::LD + dt * 8]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_step<false>(t[mt], t[mt], a[mt][nt], b0, b1);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            o[mt][dt][r] = fmaf(o[mt][dt][r], alpha[mt][r >> 1], t[mt][r]);
      }
    }
  };

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<C::STAGES - 2>();  // this thread's part of tile `it` has landed,
    __syncthreads();                 // everyone's too; all are done with `it - 1`
    {  // a later tile flies while this one is multiplied, into the stage of `it - 1`
      const int nx = it + C::STAGES - 1;
      if (nx < n_tiles) {
        const uint32_t st = smem_u32(ring) + (nx % C::STAGES) * 2 * C::STAGE_BYTES;
        load_rows<T, D, C::BN>(st, kg, p.k_st, nx * C::BN, p.Tk);
        load_rows<T, D, C::BN>(st + C::STAGE_BYTES, vg, p.v_st, nx * C::BN, p.Tk);
      }
      cp_async_commit();
    }
    float s[MT][C::NT][4], alpha[MT][2];
    scores(s, it);
    softmax(s, it, alpha);
    pv(s, it, alpha);
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[mt][i] += __shfl_xor_sync(0xffffffffu, l[mt][i], 1);
      l[mt][i] += __shfl_xor_sync(0xffffffffu, l[mt][i], 2);
    }

  T* og = static_cast<T*>(p.out);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + (warp * MT + mt) * 16 + g + 8 * i;
      if (row >= p.Tq) continue;
      const float lc = fmaxf(l[mt][i], 1e-30f);
      const float inv = 1.f / lc;
      // a row with no valid key keeps m = NEG_BIG, as the reference does
      if (t4 == 0)
        p.lse[((long long)b * p.H + h) * p.Tq + row] =
            (m2[mt][i] == NEG_BIG ? NEG_BIG : m2[mt][i] * LN2) + logf(lc);
      T* dst = og + (((long long)b * p.Tq + row) * p.H + h) * D + t4 * 2;
#pragma unroll
      for (int dt = 0; dt < C::DT; ++dt)
        store2(dst + dt * 8, o[mt][dt][2 * i] * inv, o[mt][dt][2 * i + 1] * inv);
    }
}

// ---------------------------------------------------------------- launch

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<T, D>;
  // The cap on dynamic shared memory is per kernel and per device: raised on
  // the first launch on each device, not on every launch (host time).
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    raised.fetch_or(bit, std::memory_order_relaxed);
  }
  const dim3 grid((p.Tq + C::BM - 1) / C::BM, p.H, p.B);
  flash_fwd<T, D><<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();  // a refused launch (resources) shows here, not at a sync
}

template <int D>
cudaError_t dispatch(const Params& p, int is_bf16, cudaStream_t stream) {
  if (is_bf16) return launch<__nv_bfloat16, D>(p, stream);
  return launch<float, D>(p, stream);
}

}  // namespace

// Returns 0 on success, else the CUDA error of the launch. The wrapper
// (versband_tpu_torch/ops/flash_attention.py) checks shapes, types, strides
// and the 16-byte alignment of every row before calling; D must be 32, 64,
// 96 or 128.
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
