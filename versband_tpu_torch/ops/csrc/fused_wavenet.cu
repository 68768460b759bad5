// Fused gated-WaveNet residual layer for Hopper (sm_90a): kernel K5.
//
// Replaces versband_tpu/ops/fused_wavenet.py::_layer_kernel, the Pallas TPU
// kernel of one ParallelWaveGAN residual layer. Per sample t of a batch row,
// with x [R, T], c [A, T], the fp32 skip accumulator [S, T] and dilation d:
//   gate = W0 x[t-d] + W1 x[t] + W2 x[t+d] + Wc c[t] + b_g          [2G]
//   z    = tanh(gate[:G]) * sigmoid(gate[G:])                          [G]
//   skip' = skip + Ws z + b_s                                          [S]
//   x'    = (Wo z + b_o + x[t]) * sqrt(1/2)                            [R]
// x is 0 outside [0, T) (the conv's zero padding); any T >= 1 and d >= 1;
// G, S, R <= 64 and 3R + A <= 288.
//
// What bounds it on the card: 2 * (3R + A) * 2G + 2 * G * (S + R) = 86,016
// FLOP per sample at the shipped widths (R 64, G 64, S 64, A 80) against
// 1,344 bytes moved in fp32: 64 FLOP per byte. As fp32-accurate products on
// the tensor cores (three TF32 passes, 165 TFLOP/s of the data sheet's 495)
// that is 0.251 ms per layer at T = 481,280; the bytes take 0.193 ms. So the
// tensor cores bound it, and `mma.sync`'s measured TF32 rate (322.6 TFLOP/s,
// card_ceilings.py) puts three passes at no less than 0.385 ms.
//
// What the design does about that:
// * Both products are mma.sync m16n8k8 TF32 with the weights as A (output
//   rows) and the activations as B (samples), fp32-accurate as in K1-K3
//   (mma_sm90.cuh): each operand splits into a TF32 head and a tail, a
//   product is tail.head + head.tail + head.head, the two small terms summed
//   in their own accumulator, head.head summed per chunk of 4 k-steps from
//   zero and added to a running fp32 sum outside the tensor core (whose
//   accumulator truncates). The head is cut, not rounded (split_tf32_trunc:
//   2^-20 of a value instead of 2^-21, 0.18-0.3 ms a layer cheaper). bf16 x
//   and c are exact in TF32: their tail pass is skipped. z is fp32: the
//   skip/out product keeps three passes.
// * The weights are read once per block, not once per tile: blocks are
//   persistent (one per SM) and walk the sample tiles of all batch rows. The
//   fp32 weights of both products (up to 144 KiB + 32 KiB) stay in shared
//   memory for the whole kernel, packed by the wrapper in mma fragment order
//   (one 16-byte load per lane per 16 x 8 fragment), and are split into head
//   and tail as a fragment is loaded. Pre-split weights would be twice that,
//   more than a block's 227 KiB; streaming them per tile would read 168 KiB
//   from L2 for every 64 samples.
// * The gate rows are packed so that rows r and r + 8 of an m-tile are the
//   tanh and the sigmoid row of one gate unit: the accumulator gives a lane
//   both, so z forms in registers, then goes to shared memory (fp32) as the
//   B operand of the skip/out product.
// * The X rows of a tile (x at t - d, t, t + d, then c) stream in chunks of
//   32 rows through a 3-stage cp.async ring that runs on across tiles, so the
//   next tile's first chunks load during this tile's z and skip/out work.
//   Where rows start on 16 bytes (T * element size a multiple of 16) a row
//   is copied as 16-byte pieces from the aligned sample at or before its
//   first one, and read at that offset; otherwise sample by sample (fp32:
//   4-byte cp.async; bf16: plain loads). Samples outside [0, T) are filled
//   with zeros by the copy (src-size 0), which is the conv's zero padding at
//   any dilation: no halo and no dilation limit. Which chunk comes next is
//   kept by adds (Producer), not by 64-bit divisions (0.1 ms a layer).
// * Each lane loads its skip (or x) values of a tile when the tile starts,
//   so the loads land during the products, not in the epilogue.
// A block is 16 warps, a tile 64 samples: warp w owns m-tiles 2 (w / 4) and
// 2 (w / 4) + 1 and samples 16 (w % 4) .. + 15 of both products, 48
// accumulator registers a thread (running sum, chunk partial, small terms);
// 126 registers and no spills (16 warps and no more than 128 registers: the
// skip/out loop is kept rolled). Taking one part out at a time
// (kernel_variants.py) shows the parts run one after another, not
// overlapped: the two small-term passes, the X copies, tanh and sigmoid and
// the barrier each cost about their own time.
// The TPU kernel's fixed block grid and D_HALO = 512 dilation limit have no
// counterpart here.

#include <atomic>

#include "mma_sm90.cuh"

namespace {

constexpr int NT = 64;               // samples per tile
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int NG = WARPS / 4;        // warps sharing an m-tile pair, each its own samples
constexpr int WN = NT / 8 / NG;      // n-tiles (8 samples) of a warp
constexpr int HALF = 64;             // max G, S and R
constexpr int MT = 2 * HALF / 16;    // m-tiles of either product: 8
constexpr int KC = 32;               // X rows per ring stage (4 k-steps)
constexpr int STAGES = 3;
constexpr int MAX_K = 288;           // 3R + A: what fits in shared memory beside the rest
constexpr int SO_KSTEPS = HALF / 8;  // k-steps of the skip/out product
constexpr int FRAG_BYTES = 32 * 16;  // one m16 x k8 A fragment: 16 bytes a lane
constexpr int ZLD = NT + 8;          // z row pitch in floats (72: 8 words mod 32, no conflicts)

template <typename T>
struct XCfg {
  static constexpr int VEC = 16 / (int)sizeof(T);            // samples per 16-byte copy
  // row pitch in samples: >= NT + VEC, and 8 words mod 32 (conflict-free B reads)
  static constexpr int LD = sizeof(T) == 4 ? 72 : 80;
  static constexpr int ROW_BYTES = LD * (int)sizeof(T);
  static constexpr int STAGE_BYTES = KC * ROW_BYTES;
  static constexpr int CPR = NT / VEC + 1;                    // 16-byte copies a row
};

constexpr int WSO_BYTES = MT * SO_KSTEPS * FRAG_BYTES;
constexpr int BIAS_BYTES = 2 * 2 * HALF * 4;  // bg [128], bso [128]
constexpr int ZS_BYTES = HALF * ZLD * 4;

template <typename T>
constexpr int smem_bytes(int ksteps) {
  return ksteps * MT * FRAG_BYTES + WSO_BYTES + BIAS_BYTES + ZS_BYTES +
         STAGES * XCfg<T>::STAGE_BYTES;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Params {
  const void* x;       // [B, R, T]
  const void* c;       // [B, A, T], x's type
  const float* skip;   // [B, S, T]
  const float* wg;     // [8][ksteps][32][4]: gate A fragments (m-tile, k-step, lane)
  const float* bg;     // [128], packed gate row order
  const float* wso;    // [8][8][32][4]: skip/out A fragments; rows 0-63 skip, 64-127 out
  const float* bso;    // [128]
  void* x_out;         // [B, R, T], x's type
  float* skip_out;     // [B, S, T]
  int tiles;           // B * tiles_per_row
  int tiles_per_row, R, A, S, len, d, ksteps, vec;
};

// The X row k of a tile (k < 3R: tap k / R of x channel k % R; then c rows):
// its source row and its shift in samples; rows past 3R + A are zero.
template <typename T>
__device__ __forceinline__ const T* x_row(const Params& p, int b, int k, int& shift) {
  const int R = p.R;
  shift = 0;
  if (k < 3 * R) {
    const int tap = k < R ? 0 : (k < 2 * R ? 1 : 2);
    shift = (tap - 1) * p.d;
    return static_cast<const T*>(p.x) + ((long long)b * R + (k - tap * R)) * p.len;
  }
  if (k < 3 * R + p.A) return static_cast<const T*>(p.c) + ((long long)b * p.A + k - 3 * R) * p.len;
  return nullptr;
}

// Where sample 0 of a row shifted by `shift` sits in its ring row: 16-byte
// copies start at the aligned sample at or before the row's first (t0 is a
// multiple of VEC); sample-by-sample copies at the first.
template <typename T>
__device__ __forceinline__ int read_offset(const Params& p, int shift) {
  constexpr int VEC = XCfg<T>::VEC;
  return p.vec ? ((shift % VEC) + VEC) % VEC : 0;
}

// Issue the copies of chunk `ch` (X rows [KC ch, KC ch + KC)) of the tile at
// (b, t0) into ring stage `dst`. Samples outside [0, len) become zeros.
template <typename T>
__device__ __forceinline__ void stage_chunk(const Params& p, int b, int t0, int ch,
                                            unsigned char* dst) {
  using X = XCfg<T>;
  const int k0 = ch * KC;
  if (p.vec) {
    for (int e = threadIdx.x; e < KC * X::CPR; e += THREADS) {
      const int r = e / X::CPR, j = e % X::CPR;
      int shift;
      const T* src = x_row<T>(p, b, k0 + r, shift);
      const long long s = (long long)t0 + shift - read_offset<T>(p, shift) + (long long)j * X::VEC;
      const bool in = src != nullptr && s >= 0 && s + X::VEC <= p.len;
      const void* from = in ? (const void*)(src + s) : (const void*)p.wg;
      cp_async_16(smem_u32(dst + r * X::ROW_BYTES + j * 16), from, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < KC * NT; e += THREADS) {
      const int r = e / NT, n = e % NT;
      int shift;
      const T* src = x_row<T>(p, b, k0 + r, shift);
      const long long s = (long long)t0 + shift + n;
      const bool in = src != nullptr && s >= 0 && s < p.len;
      T* to = reinterpret_cast<T*>(dst + r * X::ROW_BYTES) + n;
      if constexpr (sizeof(T) == 4) {
        const void* from = in ? (const void*)(src + s) : (const void*)p.wg;
        cp_async_4(smem_u32(to), from, in ? 4 : 0);
      } else {
        *to = in ? src[s] : __float2bfloat16(0.f);
      }
    }
  }
}

// The next chunk a block copies: chunk `ch` of tile `tile` (batch row b,
// first sample t0), into ring stage `stage`. Advanced by adds, not divisions.
struct Producer {
  int tile, b, t0, ch, stage;
};

template <typename T>
__device__ __forceinline__ void issue_next(const Params& p, Producer& pr, int nch,
                                           unsigned char* ring) {
  if (pr.tile < p.tiles) {
    stage_chunk<T>(p, pr.b, pr.t0, pr.ch, ring + pr.stage * XCfg<T>::STAGE_BYTES);
    pr.stage = pr.stage + 1 == STAGES ? 0 : pr.stage + 1;
    if (++pr.ch == nch) {
      pr.ch = 0;
      pr.tile += gridDim.x;
      pr.t0 += gridDim.x * NT;
      while (pr.t0 >= p.tiles_per_row * NT) {  // into the next batch row(s)
        pr.t0 -= p.tiles_per_row * NT;
        ++pr.b;
      }
    }
  }
  cp_async_commit();  // one group per chunk, empty or not
}

__device__ __forceinline__ void load_a(AFrag& a, const unsigned char* frag, int lane) {
  const float4 v = *reinterpret_cast<const float4*>(frag + lane * 16);
  split_tf32_trunc(v.x, a.head[0], a.tail[0]);
  split_tf32_trunc(v.y, a.head[1], a.tail[1]);
  split_tf32_trunc(v.z, a.head[2], a.tail[2]);
  split_tf32_trunc(v.w, a.head[3], a.tail[3]);
}

// One k-step of a warp's 2 x WN tiles from its two A fragments and the B
// values of its WN n-tiles (rows t and t + 4, column g). The passes go in
// three waves over the tiles (tail.head, head.tail into `small`; head.head
// into `part`), so no mma waits on the one just before it. EXACT_B (bf16
// input): B's tail is 0 and its wave is skipped.
template <bool EXACT_B>
__device__ __forceinline__ void kstep(float (&part)[2][WN][4], float (&small)[2][WN][4],
                                      const AFrag (&a)[2], const float (&b)[WN][2]) {
  uint32_t bh[WN][2], bt[WN][2];
#pragma unroll
  for (int j = 0; j < WN; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (EXACT_B) bh[j][r] = __float_as_uint(b[j][r]);
      else split_tf32_trunc(b[j][r], bh[j][r], bt[j][r]);
    }
#pragma unroll
  for (int j = 0; j < WN; ++j)
#pragma unroll
    for (int m = 0; m < 2; ++m) mma_tf32(small[m][j], a[m].tail, bh[j][0], bh[j][1]);
  if constexpr (!EXACT_B) {
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_tf32(small[m][j], a[m].head, bt[j][0], bt[j][1]);
  }
#pragma unroll
  for (int j = 0; j < WN; ++j)
#pragma unroll
    for (int m = 0; m < 2; ++m) mma_tf32(part[m][j], a[m].head, bh[j][0], bh[j][1]);
}

// read_offset of X row k: rows of the taps at t - d and t + d are read from
// an offset, the others from 0.
struct RowOffset {
  int R, lo, hi;  // rows [0, R): tap t - d at offset lo; rows [2R, 3R): t + d at hi
  __device__ __forceinline__ int operator()(int k) const {
    return k < R ? lo : (k >= 2 * R && k < 3 * R ? hi : 0);
  }
};

// Gate k-steps k0 .. k0 + NKS - 1 (rows 8 ks .. of ring stage xs), straight-line
template <typename T, int NKS>
__device__ __forceinline__ void gate_steps(float (&part)[2][WN][4], float (&small)[2][WN][4],
                                           const T* xs, const unsigned char* wg_s,
                                           RowOffset roff, int ksteps, int k0, int mp,
                                           int n_base, int lane) {
  using X = XCfg<T>;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    const int k = k0 + ks;
    AFrag a[2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
      load_a(a[m], wg_s + ((2 * mp + m) * ksteps + k) * FRAG_BYTES, lane);
    const T* x0 = xs + (ks * 8 + t4) * X::LD + roff(k * 8 + t4) + n_base + g;
    const T* x1 = xs + (ks * 8 + t4 + 4) * X::LD + roff(k * 8 + t4 + 4) + n_base + g;
    float bv[WN][2];
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      bv[j][0] = to_float(x0[8 * j]);
      bv[j][1] = to_float(x1[8 * j]);
    }
    kstep<sizeof(T) == 2>(part, small, a, bv);
  }
}

// sigmoid(v) = (1 + tanh(v / 2)) / 2: one accurate tanhf, no expf and division
__device__ __forceinline__ float sigmoid(float v) { return fmaf(0.5f, tanhf(0.5f * v), 0.5f); }

template <int N>
__device__ __forceinline__ void zero(float (&acc)[2][N][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[m][j][v] = 0.f;
}

template <int N>
__device__ __forceinline__ void add(float (&run)[2][N][4], const float (&part)[2][N][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) run[m][j][v] += part[m][j][v];
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) wavenet_layer_kernel(const Params p) {
  using X = XCfg<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ksteps = p.ksteps;
  unsigned char* wg_s = smem;                                      // [8][ksteps] fragments
  unsigned char* wso_s = wg_s + ksteps * MT * FRAG_BYTES;          // [8][8] fragments
  float* bias_s = reinterpret_cast<float*>(wso_s + WSO_BYTES);     // bg [128], bso [128]
  float* zs = bias_s + 4 * HALF;                                   // z [64][ZLD]
  unsigned char* ring = reinterpret_cast<unsigned char*>(zs + HALF * ZLD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mp = warp / NG;                // m-tiles 2 mp, 2 mp + 1 (mp < 2: skip rows)
  const int n_base = 8 * WN * (warp % NG);  // the warp's 8 WN samples of the tile
  const int nch = (ksteps * 8 + KC - 1) / KC;

  // weights and biases, once per block: their own commit group
  for (int e = threadIdx.x; e < ksteps * MT * 32; e += THREADS)
    cp_async_16(smem_u32(wg_s + e * 16), p.wg + e * 4, 16);
  for (int e = threadIdx.x; e < MT * SO_KSTEPS * 32; e += THREADS)
    cp_async_16(smem_u32(wso_s + e * 16), p.wso + e * 4, 16);
  for (int e = threadIdx.x; e < 2 * HALF / 4; e += THREADS) {
    cp_async_16(smem_u32(bias_s + 4 * e), p.bg + 4 * e, 16);
    cp_async_16(smem_u32(bias_s + 2 * HALF + 4 * e), p.bso + 4 * e, 16);
  }
  const RowOffset roff{p.R, read_offset<T>(p, -p.d), read_offset<T>(p, p.d)};
  cp_async_commit();
  Producer pr{(int)blockIdx.x, (int)blockIdx.x / p.tiles_per_row,
              (int)blockIdx.x % p.tiles_per_row * NT, 0, 0};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue_next<T>(p, pr, nch, ring);

  // The epilogue's operands of a lane: skip (skip warps) or x (out warps) at
  // rows 16 (2 mp + m) + g + 8 h, samples n_base + 8 j + 2 t4 + e.
  const bool skip_warp = mp < 2;
  const int n_ch = skip_warp ? p.S : p.R;
  const float rsqrt2 = 0.70710678118654752f;
  float run[2][WN][4], small[2][WN][4], part[2][WN][4], ep[2][WN][4];
  int stage = 0;  // the ring stage of the next chunk to compute
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int b = tile / p.tiles_per_row;
    const int t0 = (tile - b * p.tiles_per_row) * NT;
    // 0. this tile's skip or x for the epilogue, loaded now, used after the products
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int chn = 16 * (2 * mp + m) + g + 8 * h - (skip_warp ? 0 : HALF);
        const long long base = ((long long)b * n_ch + chn) * p.len;
#pragma unroll
        for (int j = 0; j < WN; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = t0 + n_base + 8 * j + 2 * t4 + e;
            float v = 0.f;
            if (chn < n_ch && t < p.len)
              v = skip_warp ? p.skip[base + t] : to_float(static_cast<const T*>(p.x)[base + t]);
            ep[m][j][2 * h + e] = v;
          }
      }
    zero(run);
    zero(small);

    // 1. gate = Wg X, chunk by chunk through the ring
    for (int ch = 0; ch < nch; ++ch) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // this chunk is in; every warp is done with the one before
      issue_next<T>(p, pr, nch, ring);
      const T* xs = reinterpret_cast<const T*>(ring + stage * X::STAGE_BYTES);
      stage = stage + 1 == STAGES ? 0 : stage + 1;
      zero(part);
      const int k0 = ch * (KC / 8);
      const int nks = min(KC / 8, ksteps - k0);
      if (nks == KC / 8) {
        gate_steps<T, KC / 8>(part, small, xs, wg_s, roff, ksteps, k0, mp, n_base, lane);
      } else {  // the last chunk of a K that is not whole chunks
        for (int ks = 0; ks < nks; ++ks)
          gate_steps<T, 1>(part, small, xs + 8 * ks * X::LD, wg_s, roff, ksteps, k0 + ks, mp,
                           n_base, lane);
      }
      add(run, part);
    }

    // 2. z = tanh(rows r) * sigmoid(rows r + 8) of each m-tile, into shared memory
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int row = 16 * (2 * mp + m) + g;  // the tanh row; row + 8 the sigmoid row
      const float ba = bias_s[row], bb = bias_s[row + 8];
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        float2 z;
        z.x = tanhf(run[m][j][0] + small[m][j][0] + ba) *
              sigmoid(run[m][j][2] + small[m][j][2] + bb);
        z.y = tanhf(run[m][j][1] + small[m][j][1] + ba) *
              sigmoid(run[m][j][3] + small[m][j][3] + bb);
        *reinterpret_cast<float2*>(zs + (8 * (2 * mp + m) + g) * ZLD + n_base + 8 * j +
                                   2 * t4) = z;
      }
    }
    zero(run);
    zero(small);
    __syncthreads();

    // 3. [skip | out] = Wso z, two chunks of 4 k-steps over the 64 units
#pragma unroll 1  // rolled: a smaller loop body, no spills
    for (int kc = 0; kc < SO_KSTEPS / 4; ++kc) {
      zero(part);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int k = 4 * kc + ks;
        AFrag a[2];
#pragma unroll
        for (int m = 0; m < 2; ++m)
          load_a(a[m], wso_s + ((2 * mp + m) * SO_KSTEPS + k) * FRAG_BYTES, lane);
        const float* z0 = zs + (8 * k + t4) * ZLD + n_base + g;
        float bv[WN][2];
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          bv[j][0] = z0[8 * j];
          bv[j][1] = z0[4 * ZLD + 8 * j];
        }
        kstep<false>(part, small, a, bv);
      }
      add(run, part);
    }

    // 4. skip' = skip + s + b_s, x' = (o + b_o + x) sqrt(1/2)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * (2 * mp + m) + g + 8 * h;
        const int chn = row - (skip_warp ? 0 : HALF);
        if (chn >= n_ch) continue;
        const float bias = bias_s[2 * HALF + row];
        const long long base = ((long long)b * n_ch + chn) * p.len;
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const int t = t0 + n_base + 8 * j + 2 * t4;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float s = run[m][j][2 * h + e] + small[m][j][2 * h + e] + bias;
            v[e] = skip_warp ? ep[m][j][2 * h + e] + s : (s + ep[m][j][2 * h + e]) * rsqrt2;
          }
          if (skip_warp) {
            float* o = p.skip_out + base + t;
            if (p.vec && t + 1 < p.len) {
              *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
            } else {
              if (t < p.len) o[0] = v[0];
              if (t + 1 < p.len) o[1] = v[1];
            }
          } else {
            T* o = static_cast<T*>(p.x_out) + base + t;
            if (t < p.len) store(o, v[0]);
            if (t + 1 < p.len) store(o + 1, v[1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  // The cap on dynamic shared memory is per kernel and per device, and the
  // SM count per device: both read on the first launch on each device.
  static std::atomic<unsigned long long> raised{0};
  static std::atomic<int> sms[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << dev;
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(wavenet_layer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<T>(MAX_K / 8));
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms[dev].store(n, std::memory_order_relaxed);
    raised.fetch_or(bit, std::memory_order_relaxed);
  }
  const int blocks = min(p.tiles, sms[dev].load(std::memory_order_relaxed));
  wavenet_layer_kernel<T><<<(unsigned)blocks, THREADS, smem_bytes<T>(p.ksteps), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Weights as fused_wavenet.pack_weights lays them out. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for shapes the
// kernel does not take, without launching).
extern "C" int vbt_fused_wavenet(const void* x, const void* c, const float* skip, const float* wg,
                                 const float* bg, const float* wso, const float* bso,
                                 void* x_out, float* skip_out, int B, int R, int A, int S, int T,
                                 int d, int is_bf16, void* stream) {
  if (B <= 0 || T <= 0 || d < 1 || R < 1 || R > HALF || S < 1 || S > HALF || A < 0 ||
      3 * R + A > MAX_K)
    return (int)cudaErrorInvalidValue;
  const long long tpr = ((long long)T + NT - 1) / NT;
  if (B * tpr > 0x3fffffffLL) return (int)cudaErrorInvalidValue;  // tile + grid: int
  const int esize = is_bf16 ? 2 : 4;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)c % 16 == 0) &&
                       ((long long)T * esize) % 16 == 0;
  Params p{x, c, skip, wg, bg, wso, bso, x_out, skip_out, (int)(B * tpr), (int)tpr,
           R, A, S, T, d, (3 * R + A + 7) / 8, aligned ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s));
}

// Shared memory of one block for these widths, in bytes.
extern "C" int vbt_fused_wavenet_smem(int R, int A, int is_bf16) {
  const int ksteps = (3 * R + A + 7) / 8;
  return is_bf16 ? smem_bytes<__nv_bfloat16>(ksteps) : smem_bytes<float>(ksteps);
}
