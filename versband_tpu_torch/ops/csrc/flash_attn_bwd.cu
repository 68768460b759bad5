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
// [8, 768, 8, 96]) K2 is 6*B*H*Tq*Tk*D = 21.7 GFLOP against 95 MB moved in
// fp32 (q, k, v, dO, lse, delta read, dq written) and K3 8*B*H*Tq*Tk*D = 29.0
// GFLOP against 114 MB, 230-255 FLOP per byte: operations bound them in
// either type. For bf16 that is the bf16 tensor-core rate; for fp32 inputs,
// which must keep fp32 accuracy, the faster of fp32 FMA and three TF32
// tensor-core passes per product.
//
// What the design does about that: all five products run on the tensor cores
// through mma.sync with fp32 accumulators.
// * bf16 inputs: m16n8k16 bf16. Tiles sit in shared memory as bf16 and reach
//   the registers through ldmatrix (.trans where the contraction runs over
//   the rows of the stored tile).
// * fp32 inputs: each operand is split in registers into a TF32 head
//   (cvt.rna.tf32.f32 of a) and a tail (a - head, of which the tensor core
//   reads the upper 10 mantissa bits), and each product is three m16n8k8
//   TF32 mma, small terms first: tail.head + head.tail + head.head.
//   Only tail.tail and the tail's own cut, ~2^-21 of a term, are dropped, so
//   the result is fp32-accurate; a single TF32 pass would not be. The tensor
//   core adds into its accumulator with truncation, which over a chain of
//   hundreds of adds costs more than the split does; so the small terms of
//   the score products are summed apart from the head.head chain, and each
//   streamed tile's share of a gradient is summed from zero and added to the
//   running gradient in fp32. exp (exp2f of the log2 e-scaled argument), the
//   scale, lse, delta and those sums stay fp32.
// * P and dS never leave registers. The accumulator fragment of the score
//   product is re-packed, after exp and the (dP - delta) factor, as the A
//   operand of the next product. For m16n8k16 two 8-column accumulator tiles
//   make one 16-deep A fragment. For m16n8k8 a thread holds columns 2t, 2t+1
//   of an accumulator tile but k-slots t, t+4 of an A fragment; the
//   contraction does not care in which order the keys are summed, so slot t
//   is read as key 2t and slot t+4 as key 2t+1, and the B operand is fetched
//   with the same permutation (scalar loads of rows 2t and 2t+1).
// * K3 computes the score tile transposed in the first place (keys as rows:
//   S^T = K Q^T, dP^T = V dO^T), so P^T and dS^T come out as row-major A
//   fragments for dV += P^T dO and dK += dS^T Q.
// * A block of 8 warps owns one 128-row tile (queries with dO in K2, keys
//   with values in K3), 16 rows per warp, loaded once; its accumulators (dQ,
//   or dK and dV) stay in registers. The other side streams through a
//   two-stage ring of cp.async loads (16 bytes per thread, zero-filled past
//   the last row), 64 rows per stage in bf16 and 32 in fp32: after the one
//   barrier of a tile the next tile's loads are started and fly while this
//   one is multiplied; K3's lse and delta ride in the ring with the query
//   tile. Rows are padded by 16 bytes: the pitch is an odd number of 16-byte
//   units, which keeps ldmatrix, and the scalar loads of the permuted fp32
//   operand, free of bank conflicts.
// * Shared memory at D = 96: 106,496 B (bf16) and 154,112 B (fp32), one block
//   of 8 warps per SM (the kernels hold 180-255 registers a thread, so 8
//   warps is what an SM takes either way). Two 64-row blocks per SM,
//   measured against one 128-row block on an H100, were no faster in bf16
//   and slower in fp32: every block streams the whole other side from L2,
//   and half as many blocks stream half as much.
// Ragged Tq/Tk edges and kv_len are masked in the kernel; P is set to 0
// before exp on masked entries, so the finite lse of a fully masked row never
// reaches exp. Every row the loads touch must start on a 16-byte boundary;
// the wrapper copies an input whose rows do not.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int BM = 128;               // rows of the owned tile: 8 warps x 16
constexpr int NUM_THREADS = 2 * BM;
constexpr float LOG2E = 1.4426950408889634f;

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

// Sizes of the shared-memory tiles of one (type, head dim).
template <typename T, int D>
struct Tile {
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int BN = BF16 ? 64 : 32;               // rows of a streamed tile
  static constexpr int VEC = 16 / (int)sizeof(T);         // elements per 16 bytes
  static constexpr int LD = D + VEC;                      // row pitch in elements
  static constexpr int PITCH = LD * (int)sizeof(T);       // row pitch in bytes
  static constexpr int KSTEPS = D * (int)sizeof(T) / 32;  // mma k-steps over D (32 bytes each)
  static constexpr int NT = BN / 8;                       // 8-column tiles of a score tile
  static constexpr int DT = D / 8;                        // 8-column tiles of a gradient
  // k-steps of the score products unrolled together: all of them in bf16; two
  // in fp32, where a full unroll makes ptxas hoist loads until it spills
  static constexpr int K_UNROLL = BF16 ? KSTEPS : 2;
  static constexpr int OWNED_BYTES = BM * PITCH;
  static constexpr int STAGE_BYTES = BN * PITCH;
  static constexpr int STATS_BYTES = 2 * BN * (int)sizeof(float);  // lse, delta of a stage
  // two owned tiles, two stages of two streamed tiles, two stages of stats
  static constexpr int SMEM_BYTES = 2 * OWNED_BYTES + 4 * STAGE_BYTES + 2 * STATS_BYTES;
  static_assert((PITCH / 16) % 2 == 1, "pitch must be an odd number of 16-byte units");
};

__device__ __forceinline__ int valid_keys(const Params& p, int b) {
  int n = p.kv_len ? p.kv_len[b] : p.Tk;
  return max(0, min(n, p.Tk));
}

// From the four registers ldmatrix delivers (bf16 pairs, or fp32 values).
template <bool BF16>
__device__ __forceinline__ void a_from_raw(AFrag& a, const uint32_t (&raw)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (BF16) {
      a.head[i] = raw[i];
    } else {
      split_tf32(__uint_as_float(raw[i]), a.head[i], a.tail[i]);
    }
  }
}

// ---------------------------------------------------------------- loads

// Rows [row0, row0 + ROWS) of one (b, h) slice into a shared-memory tile of
// pitch Tile::PITCH by cp.async; rows at or past `nrows` are zero-filled. A
// power-of-two group of threads takes a row, so each thread keeps its column
// and steps its pointers by whole rows (no division in the loop; with D = 96
// a quarter of the threads idle here, which costs less than the index math).
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const T* src, long long row_stride,
                                          int row0, int nrows) {
  using C = Tile<T, D>;
  constexpr int CHUNKS = D / C::VEC;  // 16-byte chunks per row
  constexpr int GROUP = CHUNKS <= 4 ? 4 : CHUNKS <= 8 ? 8 : CHUNKS <= 16 ? 16 : 32;
  constexpr int PASS = NUM_THREADS / GROUP;  // rows per pass over the tile
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

// lse and delta of query rows [row0, row0 + BN) into dst: [BN] lse, [BN] delta; 0 past Tq.
template <int BN>
__device__ __forceinline__ void load_stats(uint32_t dst, const float* lse, const float* delta,
                                           int row0, int Tq) {
  for (int i = threadIdx.x; i < 2 * BN; i += NUM_THREADS) {
    const int r = i % BN;
    const bool ok = row0 + r < Tq;
    const float* from = (i < BN ? lse : delta) + (ok ? row0 + r : 0);
    cp_async_4(dst + i * 4, from, ok ? 4 : 0);
  }
}

// ---------------------------------------------------------------- products

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}

// The two score-shaped products of a tile in one loop, so that their mma
// chains interleave: acc1 += A1 B1^T and acc2 += A2 B2^T for this warp's 16
// rows of A and the BN rows of B, all stored with the contraction (head) dim
// contiguous. The addresses are this lane's ldmatrix row addresses at k-step
// 0 (see lane_offsets). The tensor core adds into its accumulator with
// truncation, so in fp32 the small terms are summed apart from the
// head.head chain and added once at the end: fewer and smaller truncations.
template <typename T, int D>
__device__ __forceinline__ void score_products(float (&acc1)[Tile<T, D>::NT][4],
                                               float (&acc2)[Tile<T, D>::NT][4], uint32_t a1,
                                               uint32_t b1, uint32_t a2, uint32_t b2) {
  using C = Tile<T, D>;
  float small1[C::NT][4], small2[C::NT][4];  // unused, and dropped, in bf16
  zero(small1);
  zero(small2);
#pragma unroll C::K_UNROLL
  for (int kk = 0; kk < C::KSTEPS; ++kk) {
    uint32_t raw1[4], raw2[4];
    ldmatrix_x4(raw1, a1 + kk * 32);
    ldmatrix_x4(raw2, a2 + kk * 32);
    AFrag f1, f2;
    a_from_raw<C::BF16>(f1, raw1);
    a_from_raw<C::BF16>(f2, raw2);
#pragma unroll
    for (int np = 0; np < C::NT / 2; ++np) {  // two 8-row tiles of B per ldmatrix
      uint32_t x[4], y[4];
      ldmatrix_x4(x, b1 + np * 16 * C::PITCH + kk * 32);
      ldmatrix_x4(y, b2 + np * 16 * C::PITCH + kk * 32);
      mma_step<C::BF16>(acc1[2 * np], small1[2 * np], f1, x[0], x[1]);
      mma_step<C::BF16>(acc2[2 * np], small2[2 * np], f2, y[0], y[1]);
      mma_step<C::BF16>(acc1[2 * np + 1], small1[2 * np + 1], f1, x[2], x[3]);
      mma_step<C::BF16>(acc2[2 * np + 1], small2[2 * np + 1], f2, y[2], y[3]);
    }
  }
  if constexpr (!C::BF16) {
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc1[nt][r] += small1[nt][r];
        acc2[nt][r] += small2[nt][r];
      }
  }
}

// acc[dt] += F tile, where F (16 x BN) is the score-shaped fragment `f` held
// in registers and `tile` holds BN rows of D (the contraction runs over the
// tile's rows).
template <typename T, int D>
__device__ __forceinline__ void product_frag(float (&acc)[Tile<T, D>::DT][4],
                                             const float (&f)[Tile<T, D>::NT][4],
                                             const unsigned char* tile, int lane) {
  using C = Tile<T, D>;
  if constexpr (C::BF16) {
    // ldmatrix.trans: matrices (rows 0-7 | 8-15 of the k-step) x (cols 0-7 | 8-15)
    const uint32_t bt =
        smem_u32(tile) + ((((lane >> 3) & 1) << 3) + (lane & 7)) * C::PITCH + (lane >> 4) * 16;
#pragma unroll
    for (int j = 0; j < C::BN / 16; ++j) {
      AFrag a;
      a.head[0] = pack_bf16(f[2 * j][0], f[2 * j][1]);
      a.head[1] = pack_bf16(f[2 * j][2], f[2 * j][3]);
      a.head[2] = pack_bf16(f[2 * j + 1][0], f[2 * j + 1][1]);
      a.head[3] = pack_bf16(f[2 * j + 1][2], f[2 * j + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, bt + j * 16 * C::PITCH + dp * 32);
        mma_step<true>(acc[2 * dp], acc[2 * dp], a, bb[0], bb[1]);
        mma_step<true>(acc[2 * dp + 1], acc[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
  } else {
    // k-slot t4 is row 2 t4 of the k-step's 8 rows, slot t4 + 4 is row 2 t4 + 1
    const int g = lane >> 2, t4 = lane & 3;
    const float* bt = reinterpret_cast<const float*>(tile) + 2 * t4 * C::LD + g;
    AFrag a[C::NT];
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      split_tf32(f[nt][0], a[nt].head[0], a[nt].tail[0]);  // (g,     2 t4)     -> slot t4
      split_tf32(f[nt][2], a[nt].head[1], a[nt].tail[1]);  // (g + 8, 2 t4)
      split_tf32(f[nt][1], a[nt].head[2], a[nt].tail[2]);  // (g,     2 t4 + 1) -> slot t4 + 4
      split_tf32(f[nt][3], a[nt].head[3], a[nt].tail[3]);  // (g + 8, 2 t4 + 1)
    }
    // This tile's share is summed from zero and then added to the running
    // gradient in fp32 round-to-nearest: the tensor core's truncating adds
    // see only the BN-long chain, not the whole sequence.
#pragma unroll
    for (int dt = 0; dt < C::DT; ++dt) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const float b0 = bt[nt * 8 * C::LD + dt * 8];
        const float b1 = bt[nt * 8 * C::LD + C::LD + dt * 8];
        mma_step<false>(t, t, a[nt], __float_as_uint(b0), __float_as_uint(b1));
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[dt][r] += t[r];
    }
  }
}

// This lane's byte offsets into a tile for ldmatrix.x4: `a` for an A operand
// (rows lane % 16 of the warp's 16, second 16 bytes of the k-step for lanes
// 16-31), `b` for a B operand stored row-major over the contraction dim
// (matrices: rows 0-7 k lo, rows 0-7 k hi, rows 8-15 k lo, rows 8-15 k hi).
template <typename C>
__device__ __forceinline__ void lane_offsets(int warp, int lane, uint32_t& a, uint32_t& b) {
  a = (warp * 16 + (lane & 15)) * C::PITCH + (lane >> 4) * 16;
  b = (((lane >> 4) << 3) + (lane & 7)) * C::PITCH + ((lane >> 3) & 1) * 16;
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}

// ---------------------------------------------------------------- K2: dQ

template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dq(Params p) {
  using C = Tile<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  // Q [BM], dO [BM] owned; ring stage s: K [BN], V [BN]
  unsigned char* ring = smem + 2 * C::OWNED_BYTES;
  const uint32_t q_s = smem_u32(smem), do_s = q_s + C::OWNED_BYTES;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column pair
  const int kv_len = valid_keys(p, b);
  const int n_tiles = (kv_len + C::BN - 1) / C::BN;  // stop at the last tile with a valid key

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* og = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;

  float acc[C::DT][4];
  zero(acc);

  if (n_tiles > 0) {
    load_rows<T, D, BM>(q_s, qg, p.q_st, q0, p.Tq);
    load_rows<T, D, BM>(do_s, og, p.o_st, q0, p.Tq);
    load_rows<T, D, C::BN>(smem_u32(ring), kg, p.k_st, 0, p.Tk);
    load_rows<T, D, C::BN>(smem_u32(ring) + C::STAGE_BYTES, vg, p.v_st, 0, p.Tk);
    cp_async_commit();

    // Each thread holds rows g (index 0) and g + 8 (index 1) of its warp's 16.
    float lse[2], delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + warp * 16 + g + 8 * i;
      const long long idx = ((long long)b * p.H + h) * p.Tq + row;
      lse[i] = row < p.Tq ? p.lse[idx] * LOG2E : 0.f;  // exp(x) = exp2(x log2 e)
      delta[i] = row < p.Tq ? p.delta[idx] : 0.f;
    }
    uint32_t a_off, b_off;
    lane_offsets<C>(warp, lane, a_off, b_off);
    const float scale_log2 = p.scale * LOG2E;

    for (int it = 0; it < n_tiles; ++it) {
      unsigned char* k_t = ring + (it & 1) * 2 * C::STAGE_BYTES;
      unsigned char* v_t = k_t + C::STAGE_BYTES;
      cp_async_wait<0>();  // this thread's part of tile `it` has landed
      __syncthreads();     // ... and everyone's; every warp is done with tile `it - 1`
      if (it + 1 < n_tiles) {  // the next tile flies while this one is multiplied
        const uint32_t nxt = smem_u32(ring) + ((it + 1) & 1) * 2 * C::STAGE_BYTES;
        load_rows<T, D, C::BN>(nxt, kg, p.k_st, (it + 1) * C::BN, p.Tk);
        load_rows<T, D, C::BN>(nxt + C::STAGE_BYTES, vg, p.v_st, (it + 1) * C::BN, p.Tk);
        cp_async_commit();
      }

      float s[C::NT][4], dp[C::NT][4];
      zero(s);
      zero(dp);
      score_products<T, D>(s, dp, q_s + a_off, smem_u32(k_t) + b_off, do_s + a_off,
                           smem_u32(v_t) + b_off);  // S = Q K^T, dP = dO V^T
      const int n0 = it * C::BN;
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = n0 + nt * 8 + t4 * 2 + (r & 1);
          const float pij = col < kv_len ? exp2f(s[nt][r] * scale_log2 - lse[r >> 1]) : 0.f;
          dp[nt][r] = pij * (dp[nt][r] - delta[r >> 1]);  // dS
        }
      }
      product_frag<T, D>(acc, dp, k_t, lane);  // dQ += dS K
    }
  }

  T* dqg = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= p.Tq) continue;
    T* dst = dqg + (((long long)b * p.Tq + row) * p.H + h) * D + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < C::DT; ++dt)
      store2(dst + dt * 8, acc[dt][2 * i] * p.scale, acc[dt][2 * i + 1] * p.scale);
  }
}

// ---------------------------------------------------------------- K3: dK, dV

template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dkv(Params p) {
  using C = Tile<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  // K [BM], V [BM] owned; ring stage s: Q [BN], dO [BN]; then stats stage s: lse [BN], delta [BN]
  unsigned char* ring = smem + 2 * C::OWNED_BYTES;
  unsigned char* stats = ring + 4 * C::STAGE_BYTES;
  const uint32_t k_s = smem_u32(smem), v_s = k_s + C::OWNED_BYTES;

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kv_len = valid_keys(p, b);

  float dk[C::DT][4], dv[C::DT][4];
  zero(dk);
  zero(dv);

  if (k0 < kv_len) {  // key tiles wholly past kv_len have zero gradients
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
    const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
    const T* og = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
    const float* lse_g = p.lse + ((long long)b * p.H + h) * p.Tq;
    const float* delta_g = p.delta + ((long long)b * p.H + h) * p.Tq;
    const int n_tiles = (p.Tq + C::BN - 1) / C::BN;

    load_rows<T, D, BM>(k_s, kg, p.k_st, k0, p.Tk);
    load_rows<T, D, BM>(v_s, vg, p.v_st, k0, p.Tk);
    load_rows<T, D, C::BN>(smem_u32(ring), qg, p.q_st, 0, p.Tq);
    load_rows<T, D, C::BN>(smem_u32(ring) + C::STAGE_BYTES, og, p.o_st, 0, p.Tq);
    load_stats<C::BN>(smem_u32(stats), lse_g, delta_g, 0, p.Tq);
    cp_async_commit();

    uint32_t a_off, b_off;
    lane_offsets<C>(warp, lane, a_off, b_off);
    // This thread's two key rows, g (index 0) and g + 8 (index 1) of its warp's 16.
    const bool key_ok[2] = {k0 + warp * 16 + g < kv_len, k0 + warp * 16 + g + 8 < kv_len};

    for (int it = 0; it < n_tiles; ++it) {
      unsigned char* q_t = ring + (it & 1) * 2 * C::STAGE_BYTES;
      unsigned char* do_t = q_t + C::STAGE_BYTES;
      const float* lse_s = reinterpret_cast<const float*>(stats + (it & 1) * C::STATS_BYTES);
      const float* delta_s = lse_s + C::BN;
      cp_async_wait<0>();
      __syncthreads();
      if (it + 1 < n_tiles) {
        const int m1 = (it + 1) * C::BN;
        const uint32_t nxt = smem_u32(ring) + ((it + 1) & 1) * 2 * C::STAGE_BYTES;
        load_rows<T, D, C::BN>(nxt, qg, p.q_st, m1, p.Tq);
        load_rows<T, D, C::BN>(nxt + C::STAGE_BYTES, og, p.o_st, m1, p.Tq);
        load_stats<C::BN>(smem_u32(stats) + ((it + 1) & 1) * C::STATS_BYTES, lse_g, delta_g, m1,
                          p.Tq);
        cp_async_commit();
      }

      float st[C::NT][4], dpt[C::NT][4];
      zero(st);
      zero(dpt);
      score_products<T, D>(st, dpt, k_s + a_off, smem_u32(q_t) + b_off, v_s + a_off,
                           smem_u32(do_t) + b_off);  // S^T = K Q^T, dP^T = V dO^T
      const int m0 = it * C::BN;
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const int c = nt * 8 + t4 * 2;  // this thread's two query columns: c, c + 1
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + c);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const bool ok = key_ok[r >> 1] && m0 + c + (r & 1) < p.Tq;
          const float lse = (r & 1) ? l2.y : l2.x, delta = (r & 1) ? d2.y : d2.x;
          const float pij = ok ? exp2f((st[nt][r] * p.scale - lse) * LOG2E) : 0.f;
          st[nt][r] = pij;                          // P^T
          dpt[nt][r] = pij * (dpt[nt][r] - delta);  // dS^T
        }
      }
      product_frag<T, D>(dv, st, do_t, lane);  // dV += P^T dO
      product_frag<T, D>(dk, dpt, q_t, lane);  // dK += dS^T Q
    }
  }

  T* dkg = static_cast<T*>(p.dk);
  T* dvg = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + warp * 16 + g + 8 * i;
    if (row >= p.Tk) continue;
    const long long off = (((long long)b * p.Tk + row) * p.H + h) * D + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < C::DT; ++dt) {
      store2(dkg + off + dt * 8, dk[dt][2 * i] * p.scale, dk[dt][2 * i + 1] * p.scale);
      store2(dvg + off + dt * 8, dv[dt][2 * i], dv[dt][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename KernelT>
cudaError_t launch(KernelT kernel, int smem, int rows, const Params& p, cudaStream_t stream) {
  // Above 48 KB a kernel needs the cap raised (per kernel, cheap to repeat).
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + BM - 1) / BM, p.H, p.B);
  kernel<<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();  // a refused launch (resources) shows here, not at a sync
}

template <int D>
cudaError_t dispatch_dq(const Params& p, int is_bf16, cudaStream_t s) {
  if (is_bf16)
    return launch(flash_bwd_dq<__nv_bfloat16, D>, Tile<__nv_bfloat16, D>::SMEM_BYTES, p.Tq, p, s);
  return launch(flash_bwd_dq<float, D>, Tile<float, D>::SMEM_BYTES, p.Tq, p, s);
}

template <int D>
cudaError_t dispatch_dkv(const Params& p, int is_bf16, cudaStream_t s) {
  if (is_bf16)
    return launch(flash_bwd_dkv<__nv_bfloat16, D>, Tile<__nv_bfloat16, D>::SMEM_BYTES, p.Tk, p,
                  s);
  return launch(flash_bwd_dkv<float, D>, Tile<float, D>::SMEM_BYTES, p.Tk, p, s);
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
// types, strides and the 16-byte alignment of every row before calling.
// `strides` holds the 12 element strides (b, t, h) of q, k, v and dO in that
// order; D must be 32, 64, 96 or 128.
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
