// Gated-attention MIL pooling (CLAM_SB's Attn_Net_Gated + bag classifier)
// over a whole bag, for Hopper (sm_90a).
//
// Replaces the TPU kernels of hipt_abmil_atec23_tpu/ops/gated_attention_pool.py:
// _kernel (launcher _pallas_pool), both its logits mode and its partial_out
// mode, and _kernel_dma (launcher _pallas_pool_dma), which computes the same
// function through a manual DMA ring. The ring works around the TPU's
// automatic block pipeline; this kernel reads the unpadded bag in place, so
// both TPU launchers map to the same launch here.
//
// On the TPU the grid walks the instance tiles in order and carries the
// online-softmax state (m, l, acc) from one step to the next. Here a
// persistent grid of CTAs (as many as fit on the card at once) walks the
// 64-instance tiles round robin, each CTA carrying its own (m, l, acc[L]) in
// shared memory through the same recurrence; one combine CTA then merges the
// CTAs' partials like two flash-attention blocks:
//
//   pass 1, per tile:
//     h = relu(x W_f + b_f)  [64, L];
//     z_a = h W_a + b_a, z_b = h W_b + b_b  [64, D_att],
//     s = sum_d w_c[d] tanh(z_a) sigmoid(z_b) + b_c; invalid rows get
//     s = -1e30 and every s is written to scores[N];
//     m' = max(m, max s), alpha = e^(m - m'), e = exp(s - m') for valid
//     rows and exactly 0 for masked ones (also while m is still -1e30, so an
//     all-masked bag pools nothing), l' = l alpha + sum e,
//     acc' = acc alpha + e^T h.
//   pass 2, one CTA: m_g = max m, w = e^(m - m_g), l_g = sum l w,
//     acc_g = sum acc w; then either the partial (acc_g, m_g, l_g), or
//     logits = (acc_g / max(l_g, 1e-30)) W_cls + b_cls.
//
// The TPU kernel upcasts the bag to f32, and the kernel is held to its f32
// plain version at 1e-4, so both products must be f32-accurate. Pass 1 has
// two variants, chosen by the head's width:
//
//   tensor cores (every head but the narrowest; L <= MAX_L = 768): the two
//     products on wgmma tf32 as three products each, A_hi B_hi + A_hi B_lo
//     + A_lo B_hi with X = tf32(X) + tf32(X - tf32(X)), which keeps ~22 of
//     f32's 24 bits (tf32 alone keeps 11). One producer warp streams the
//     weights with TMA into a ring (each stage the hi and lo halves of a
//     32-deep k-block of 2 NW weight rows, 128-byte swizzle); two consumer
//     warpgroups take NW columns each. The wrapper prepares the weights
//     once: W_f^T [L, D_in] and [W_a | W_b]^T with z_a and z_b rows
//     interleaved (so one thread holds z_a[d] and z_b[d] side by side), K
//     padded to 8 and permuted within each 8 (k, k + 4 <- 2k, 2k + 1), split
//     into hi and lo. The permutation makes the accumulator's column pairs
//     (2t, 2t + 1) the tf32 A fragment's (t, t + 4): each thread loads its
//     A values as float2 pairs (the bag from device memory, h from a
//     per-CTA scratch) and splits them in registers. h goes to that scratch
//     (64 L floats per CTA, L2-resident) in the layout its threads read it
//     back, for z's A operand and for acc += e^T h once the tile's scores
//     are known: nothing of h has to fit shared memory, so L is bounded
//     only by the acc and tile-sum arrays (MAX_L).
//   narrow (L <= 32 and D_att <= 32, the HIPT heads): register-tiled f32 FMA
//     on the CUDA cores (8 rows per warp, operands staged through shared
//     memory in 32-deep chunks), the h tile transposed in shared memory.
//
// Bound at the reference CLAM widths (D_in 1024, L 512, D_att 256):
// ~1.6 MFLOP per instance against 4 KB read, so operations bound it; the
// least time is the lesser of the f32 FMA rate (67 TFLOP/s) and three tf32
// passes at 494.7 TFLOP/s (157 GFLOP at [100000, 1024]: 2.35 and 0.95 ms).
// Each 64-row tile reads the split weights (6 MB at that head) from L2,
// ~9.4 GB at that bag, which may bound the tensor-core variant first. At
// the HIPT widths (192, 16, 8) reading the bag bounds it.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using hk::kNegInf;

constexpr int TILE = 64;         // instances per tile
constexpr int THREADS = 256;     // narrow variant: 8 warps
constexpr int ROWS = 8;          // rows per warp
constexpr int KC = 32;           // reduction depth per staged chunk
constexpr int XP = TILE + 4;     // row stride of the transposed tiles
constexpr int MAX_PARTS = 1024;  // pass-1 CTAs, one partial each
constexpr int MAX_L = 768;       // tensor-core variant: acc and tile sums
constexpr size_t SMEM_LIMIT = 232448;  // per block on sm_90
constexpr int kMaxDevices = 64;        // host-side query caches

// the narrow variant takes the head
__host__ __device__ constexpr bool narrow(int L, int Da) {
  return L <= 32 && Da <= 32;
}

// floats of dynamic shared memory the narrow pass 1 needs (one column per
// lane: the chunk width is 32)
__host__ __device__ constexpr size_t smem_floats(int L) {
  return (size_t)L * XP + KC * XP + 2 * KC * 32 + L + 2 * TILE;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// sum (or max) over the CTA; red holds one slot per warp
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < THREADS / 32; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

constexpr int XR = TILE * KC / THREADS;  // x values each thread stages

// this thread's share of the x chunk [row0, row0 + 64) x [k0, k0 + KC),
// zero past the bag's edges (e = tid + i * THREADS, row e / KC, col e % KC)
__device__ __forceinline__ void load_x(float (&xr)[XR],
                                       const float* __restrict__ bag,
                                       int row0, int k0, int N, int Din) {
#pragma unroll
  for (int i = 0; i < XR; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = row0 + e / KC, c = k0 + e % KC;
    xr[i] = (r < N && c < Din) ? bag[(size_t)r * Din + c] : 0.f;
  }
}

// this thread's share of the weight chunk w[k0 .. k0 + KC)[c0 .. c0 + LC)
// of a [K, cols] matrix, zero past its edges
template <int CPT>
__device__ __forceinline__ void load_w(float (&wr)[KC * CPT / 8],
                                       const float* __restrict__ w, int k0,
                                       int c0, int K, int cols) {
  constexpr int LC = 32 * CPT;
#pragma unroll
  for (int i = 0; i < KC * CPT / 8; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int k = k0 + e / LC, c = c0 + e % LC;
    wr[i] = (k < K && c < cols) ? w[(size_t)k * cols + c] : 0.f;
  }
}

// The narrow variant, one column per lane. part: [gridDim.x][2 + L] = (m,
// l, acc[0..L)) of each CTA
__global__ void __launch_bounds__(THREADS)
pool_pass1(const float* __restrict__ bag, const uint8_t* __restrict__ mask,
           int n_valid, int N, int Din, int L, int Da,
           const float* __restrict__ wf, const float* __restrict__ bf,
           const float* __restrict__ wa, const float* __restrict__ ba,
           const float* __restrict__ wb, const float* __restrict__ bb,
           const float* __restrict__ wc, const float* __restrict__ bc,
           float* __restrict__ scores, float* __restrict__ part) {
  constexpr int CPT = 1;
  constexpr int LC = 32 * CPT;  // output columns per chunk
  constexpr int WR = KC * LC / THREADS;  // weight values each thread stages
  extern __shared__ float4 smem4[];
  float* hT = reinterpret_cast<float*>(smem4);  // [L][XP]  h transposed
  float* xT = hT + (size_t)L * XP;              // [KC][XP] x chunk transposed
  float* w1 = xT + KC * XP;                     // [KC][LC] W_f or W_a chunk
  float* w2 = w1 + KC * LC;                     // [KC][LC] W_b chunk
  float* acc = w2 + KC * LC;                    // [L] running acc
  float* s_sm = acc + L;                        // [TILE] scores
  float* e_sm = s_sm + TILE;                    // [TILE] weights
  __shared__ float run[3];                      // m, l, alpha

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * ROWS;
  for (int l = tid; l < L; l += THREADS) acc[l] = 0.f;
  if (tid == 0) {
    run[0] = kNegInf;
    run[1] = 0.f;
  }
  const int tiles = (N + TILE - 1) / TILE;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * TILE;

    // ---- h = relu(x W_f + b_f) -> hT. Each chunk's operands are loaded
    // into registers one chunk ahead, so the loads overlap the FMAs.
    for (int c0 = 0; c0 < L; c0 += LC) {
      float a[ROWS][CPT];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) a[i][j] = 0.f;
      float xr[XR], wr[WR];
      load_x(xr, bag, row0, 0, N, Din);
      load_w<CPT>(wr, wf, 0, c0, Din, L);
      for (int k0 = 0; k0 < Din; k0 += KC) {
        __syncthreads();
#pragma unroll
        for (int i = 0; i < XR; ++i) {
          const int e = threadIdx.x + i * THREADS;
          xT[(e % KC) * XP + e / KC] = xr[i];
        }
#pragma unroll
        for (int i = 0; i < WR; ++i) w1[threadIdx.x + i * THREADS] = wr[i];
        __syncthreads();
        if (k0 + KC < Din) {
          load_x(xr, bag, row0, k0 + KC, N, Din);
          load_w<CPT>(wr, wf, k0 + KC, c0, Din, L);
        }
#pragma unroll 4
        for (int kk = 0; kk < KC; ++kk) {
          const float4 x0 = *reinterpret_cast<const float4*>(xT + kk * XP + r0);
          const float4 x1 =
              *reinterpret_cast<const float4*>(xT + kk * XP + r0 + 4);
          const float xv[ROWS] = {x0.x, x0.y, x0.z, x0.w,
                                  x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const float w = w1[kk * LC + lane + 32 * j];
#pragma unroll
            for (int i = 0; i < ROWS; ++i) a[i][j] = fmaf(xv[i], w, a[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = c0 + lane + 32 * j;
        if (col < L) {
          const float b = bf[col];
#pragma unroll
          for (int i = 0; i < ROWS; ++i)
            hT[col * XP + r0 + i] = fmaxf(a[i][j] + b, 0.f);
        }
      }
    }

    // ---- s = sum_d w_c[d] tanh(h W_a + b_a) sigmoid(h W_b + b_b) + b_c
    float sp[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) sp[i] = 0.f;
    for (int d0 = 0; d0 < Da; d0 += LC) {
      float za[ROWS][CPT], zb[ROWS][CPT];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) za[i][j] = zb[i][j] = 0.f;
      float ar[WR], br[WR];
      load_w<CPT>(ar, wa, 0, d0, L, Da);
      load_w<CPT>(br, wb, 0, d0, L, Da);
      for (int k0 = 0; k0 < L; k0 += KC) {
        __syncthreads();  // also orders the hT writes above before reads
#pragma unroll
        for (int i = 0; i < WR; ++i) {
          w1[threadIdx.x + i * THREADS] = ar[i];
          w2[threadIdx.x + i * THREADS] = br[i];
        }
        __syncthreads();
        if (k0 + KC < L) {
          load_w<CPT>(ar, wa, k0 + KC, d0, L, Da);
          load_w<CPT>(br, wb, k0 + KC, d0, L, Da);
        }
        const int kmax = min(KC, L - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          const float* hp = hT + (size_t)(k0 + kk) * XP + r0;
          const float4 h0 = *reinterpret_cast<const float4*>(hp);
          const float4 h1 = *reinterpret_cast<const float4*>(hp + 4);
          const float hv[ROWS] = {h0.x, h0.y, h0.z, h0.w,
                                  h1.x, h1.y, h1.z, h1.w};
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const float u = w1[kk * LC + lane + 32 * j];
            const float v = w2[kk * LC + lane + 32 * j];
#pragma unroll
            for (int i = 0; i < ROWS; ++i) {
              za[i][j] = fmaf(hv[i], u, za[i][j]);
              zb[i][j] = fmaf(hv[i], v, zb[i][j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int d = d0 + lane + 32 * j;
        if (d < Da) {
          const float bad = ba[d], bbd = bb[d], wcd = wc[d];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            const float g = 1.f / (1.f + expf(-(zb[i][j] + bbd)));
            sp[i] = fmaf(tanhf(za[i][j] + bad) * g, wcd, sp[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float v = warp_sum(sp[i]);
      if (lane == 0) {
        const int row = row0 + r0 + i;
        const bool valid =
            row < N && (mask != nullptr ? mask[row] != 0 : row < n_valid);
        const float s = valid ? v + bc[0] : kNegInf;
        s_sm[r0 + i] = s;
        if (row < N) scores[row] = s;
      }
    }
    __syncthreads();

    // ---- online-softmax recurrence over this tile
    if (warp == 0) {
      const float v0 = s_sm[lane], v1 = s_sm[lane + 32];
      const float mt = warp_max(fmaxf(v0, v1));
      const float m_prev = run[0];
      const float m_new = fmaxf(m_prev, mt);
      const float e0 = v0 > 0.5f * kNegInf ? expf(v0 - m_new) : 0.f;
      const float e1 = v1 > 0.5f * kNegInf ? expf(v1 - m_new) : 0.f;
      e_sm[lane] = e0;
      e_sm[lane + 32] = e1;
      const float lsum = warp_sum(e0 + e1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        run[0] = m_new;
        run[1] = run[1] * alpha + lsum;
        run[2] = alpha;
      }
    }
    __syncthreads();
    const float alpha = run[2];
    for (int l = tid; l < L; l += THREADS) {
      const float* hp = hT + (size_t)l * XP;
      float sum = 0.f;
#pragma unroll 4
      for (int r = 0; r < TILE; r += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(hp + r);
        sum = fmaf(e_sm[r], hv.x, sum);
        sum = fmaf(e_sm[r + 1], hv.y, sum);
        sum = fmaf(e_sm[r + 2], hv.z, sum);
        sum = fmaf(e_sm[r + 3], hv.w, sum);
      }
      acc[l] = fmaf(acc[l], alpha, sum);
    }
  }

  __syncthreads();
  float* out = part + (size_t)blockIdx.x * (2 + L);
  if (tid == 0) {
    out[0] = run[0];
    out[1] = run[1];
  }
  for (int l = tid; l < L; l += THREADS) out[2 + l] = acc[l];
}

// Merges the pass-1 partials. Logits mode: logits [C]. Partial mode
// (logits == nullptr): acc_out [L] unnormalised at the global max and
// ml_out = (m_g, l_g).
__global__ void __launch_bounds__(THREADS)
pool_combine(const float* __restrict__ part, int parts, int L, int C,
             const float* __restrict__ wcls, const float* __restrict__ bcls,
             float* __restrict__ logits, float* __restrict__ acc_out,
             float* __restrict__ ml_out) {
  __shared__ float w_sm[MAX_PARTS];
  __shared__ float red[THREADS / 32];
  __shared__ float col_sm[THREADS / 32][32];
  extern __shared__ float pooled[];  // [L]
  const int tid = threadIdx.x;
  const size_t stride = 2 + L;
  float m = kNegInf;
  for (int t = tid; t < parts; t += THREADS) m = fmaxf(m, part[t * stride]);
  const float mg = block_reduce<true>(m, red);
  float l_loc = 0.f;
  for (int t = tid; t < parts; t += THREADS) {
    const float w = expf(part[t * stride] - mg);
    w_sm[t] = w;
    l_loc = fmaf(part[t * stride + 1], w, l_loc);
  }
  const float lg = block_reduce<false>(l_loc, red);  // syncs w_sm too
  const float inv = 1.f / fmaxf(lg, 1e-30f);
  // 32 columns at a time: lanes over columns, warps over partials
  const int lane = tid & 31, warp = tid >> 5;
  for (int l0 = 0; l0 < L; l0 += 32) {
    const int l = l0 + lane;
    float a = 0.f;
    if (l < L)
      for (int t = warp; t < parts; t += THREADS / 32)
        a = fmaf(part[t * stride + 2 + l], w_sm[t], a);
    __syncthreads();
    col_sm[warp][lane] = a;
    __syncthreads();
    if (warp == 0 && l < L) {
      float sum = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) sum += col_sm[w][lane];
      if (logits == nullptr)
        acc_out[l] = sum;
      else
        pooled[l] = sum * inv;
    }
  }
  if (logits == nullptr) {
    if (tid == 0) {
      ml_out[0] = mg;
      ml_out[1] = lg;
    }
    return;
  }
  __syncthreads();
  for (int c = tid; c < C; c += THREADS) {
    float z = bcls[c];
    for (int l = 0; l < L; ++l) z = fmaf(pooled[l], wcls[(size_t)l * C + c], z);
    logits[c] = z;
  }
}


// ---------------------------------------------------------------- tensor cores
namespace tc {

constexpr int CONSUMERS = 2;                     // warpgroups
constexpr int THREADS = 128 * CONSUMERS + 32;    // + the producer warp
constexpr int PRODUCER_WARP = 4 * CONSUMERS;
constexpr int KB = 32;                           // f32 K per stage: 128 B
constexpr int MAX_STAGES = 8;

// NW output columns per warpgroup and pass: a stage holds the hi and lo
// halves of a k-block of 2 NW weight rows
template <int NW>
struct Cfg {
  static constexpr uint32_t HALF = 2 * NW * KB * sizeof(float);
  static constexpr uint32_t STAGE = 2 * HALF;
  static constexpr int FIT =
      (int)((SMEM_LIMIT - 1024 - 2 * MAX_L * sizeof(float) - 4096) / STAGE);
  static constexpr int S = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr size_t SMEM = 1024 + (size_t)S * STAGE;
  static_assert(S >= 2, "the ring needs two stages");
};

// NW 64 for heads up to 128 columns wide, else 128
__host__ __device__ constexpr int nw_for(int L, int Da) {
  return (L <= 128 && 2 * Da <= 128) ? 64 : 128;
}

// passes of 2 NW columns over h (GEMM 1) and z (GEMM 2)
__host__ __device__ inline int passes(int cols, int nw) {
  return (cols + 2 * nw - 1) / (2 * nw);
}

// float2s of h scratch per CTA: its 64 rows of 2 NW P1 columns
__host__ __device__ inline size_t scratch_float2(int L, int nw) {
  return (size_t)passes(L, nw) * nw * 64;
}

template <int NW>
__device__ __forceinline__ void mma(float (&d)[NW / 8][4], const uint32_t* a,
                                    uint64_t db) {
  if constexpr (NW == 128)
    hk::wgmma_m64n128k8_tf32(d, a, db);
  else
    hk::wgmma_m64n64k8_tf32(d, a, db);
}

// One pass of acc = A . B^T over ``kbs`` k-blocks of the ring: B rows
// wg NW .. of each stage's hi and lo halves; A's 16 values of k-block kb
// for this thread come from load_a(kb, raw) as (row g, col 2t), (g, 2t +
// 1), (g + 8, 2t), (g + 8, 2t + 1) of each of its four k8 blocks. A k-block's
// A values are loaded one k-block ahead and split while the previous
// k-block's twelve products run; their registers alternate between two
// sets, so no product in flight reads a register being rewritten.
template <int NW, class LoadA>
__device__ __forceinline__ void pass(float (&acc)[NW / 8][4], int kbs,
                                     LoadA load_a, unsigned char* ring,
                                     uint64_t* full, uint64_t* empty,
                                     uint32_t& it, int wg) {
  using C = Cfg<NW>;
  constexpr int S = C::S;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float raw[16];
  uint32_t fr[2][4][8];  // [set][k8][hi a0..a3, lo a0..a3]
  uint32_t prev = 0;
  load_a(0, raw);
  auto step = [&](auto P, int kb) {
    constexpr int p = decltype(P)::value;
#pragma unroll
    for (int k8 = 0; k8 < 4; ++k8) {
      uint32_t* f = fr[p][k8];
      hk::tf32_split(raw[4 * k8 + 0], f[0], f[4]);  // a0: row g, col t
      hk::tf32_split(raw[4 * k8 + 2], f[1], f[5]);  // a1: row g + 8, col t
      hk::tf32_split(raw[4 * k8 + 1], f[2], f[6]);  // a2: row g, col t + 4
      hk::tf32_split(raw[4 * k8 + 3], f[3], f[7]);  // a3: row g + 8, t + 4
    }
    if (kb + 1 < kbs) load_a(kb + 1, raw);
    const uint32_t cur = it++;
    const int s = cur % S;
    hk::mbar_wait(&full[s], (cur / S) & 1);
    unsigned char* st = ring + s * C::STAGE;
    const uint64_t bh = hk::swz_desc(st + wg * NW * 128, 128);
    const uint64_t bl = hk::swz_desc(st + C::HALF + wg * NW * 128, 128);
    hk::wgmma_fence();
#pragma unroll
    for (int k8 = 0; k8 < 4; ++k8) {
      mma<NW>(acc, fr[p][k8], bh + 2 * k8);
      mma<NW>(acc, fr[p][k8], bl + 2 * k8);
      mma<NW>(acc, fr[p][k8] + 4, bh + 2 * k8);
    }
    hk::wgmma_commit();
    hk::wgmma_wait<1>();  // the previous k-block's products are done
    if (kb > 0 && lane == 0) hk::mbar_arrive(&empty[prev % S]);
    prev = cur;
  };
  for (int kb = 0; kb < kbs; kb += 2) {
    step(std::integral_constant<int, 0>{}, kb);
    if (kb + 1 < kbs) step(std::integral_constant<int, 1>{}, kb + 1);
  }
  hk::wgmma_wait<0>();
  hk::fence_regs(acc);
  if (lane == 0) hk::mbar_arrive(&empty[prev % S]);
}

// wfmap: [2, L, Dk] f32, the hi and lo of W_f^T (K permuted); wzmap:
// [2, 2 Da, Lk] f32, of [W_a | W_b]^T with rows 2d = W_a[:, d], 2d + 1 =
// W_b[:, d]; boxes of 32 columns x 2 NW rows. scratch: [grid][P1][2][NW / 8]
// [2][128] float2, h of this CTA's tile as each consumer thread holds it.
template <int NW>
__global__ void __launch_bounds__(THREADS, 1)
pool_pass1_tc(const __grid_constant__ CUtensorMap wfmap,
              const __grid_constant__ CUtensorMap wzmap,
              const float* __restrict__ bag, const uint8_t* __restrict__ mask,
              int n_valid, int N, int Din, int L, int Da,
              const float* __restrict__ bf, const float* __restrict__ ba,
              const float* __restrict__ bb, const float* __restrict__ wc,
              const float* __restrict__ bc, float* __restrict__ scores,
              float* __restrict__ part, float2* scratch) {
  using C = Cfg<NW>;
  constexpr int S = C::S;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[S], empty[S];
  __shared__ float acc_s[MAX_L], tsum[MAX_L], srow[TILE], e_sm[TILE];
  __shared__ float run[3];  // m, l, alpha
  unsigned char* ring = hk::align1024(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tid = threadIdx.x;
  const int tiles = (N + TILE - 1) / TILE;
  const int Lk = (L + 7) / 8 * 8;
  const int P1 = passes(L, NW), KB1 = ((Din + 7) / 8 * 8 + KB - 1) / KB;
  const int P2 = passes(2 * Da, NW), KB2 = (Lk + KB - 1) / KB;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hk::mbar_init(&full[s], 1);
      hk::mbar_init(&empty[s], 4 * CONSUMERS);
    }
    hk::mbar_init_fence();
    run[0] = kNegInf;
    run[1] = 0.f;
  }
  for (int c = tid; c < MAX_L; c += THREADS) acc_s[c] = tsum[c] = 0.f;
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      uint32_t it = 0;
      auto load = [&](const CUtensorMap* map, int p, int kb) {
        const int s = it % S;
        hk::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);  // first round passes
        hk::mbar_expect_tx(&full[s], C::STAGE);
        unsigned char* st = ring + s * C::STAGE;
        hk::tma_load_3d(st, map, &full[s], KB * kb, 2 * NW * p, 0);
        hk::tma_load_3d(st + C::HALF, map, &full[s], KB * kb, 2 * NW * p, 1);
        ++it;
      };
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int p = 0; p < P1; ++p)
          for (int kb = 0; kb < KB1; ++kb) load(&wfmap, p, kb);
        for (int p = 0; p < P2; ++p)
          for (int kb = 0; kb < KB2; ++kb) load(&wzmap, p, kb);
      }
    }
    return;
  }

  const int wg = warp >> 2, wr = (warp & 3) * 16;
  const int g = lane >> 2, t4 = lane & 3;
  const int lid = tid & 127;  // thread within its warpgroup
  float2* scr = scratch + (size_t)blockIdx.x * P1 * NW * 64;
  // h(row g or g + 8 of this warp, columns 2 NW p + NW q + 8 j + 2 t4, + 1)
  // as written by thread lid of warpgroup q
  auto hidx = [&](int p, int q, int j, int half) {
    return (size_t)((((p * 2 + q) * (NW / 8) + j) * 2 + half) * 128 + lid);
  };
  const bool even = (Din & 1) == 0;
  float acc[NW / 8][4];
  uint32_t it = 0;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * TILE;
    const int ra = row0 + wr + g, rb = ra + 8;
    if (tid < TILE) srow[tid] = 0.f;  // read after the barrier below
    // ---- h = relu(x W_f + b_f) into the scratch
    auto load_x = [&](int kb, float (&raw)[16]) {
#pragma unroll
      for (int k8 = 0; k8 < 4; ++k8) {
        const int c = KB * kb + 8 * k8 + 2 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = h ? rb : ra;
          float2 v = make_float2(0.f, 0.f);
          if (r < N) {
            const float* p = bag + (size_t)r * Din + c;
            if (even) {
              if (c < Din) v = *reinterpret_cast<const float2*>(p);
            } else {
              if (c < Din) v.x = p[0];
              if (c + 1 < Din) v.y = p[1];
            }
          }
          raw[4 * k8 + 2 * h] = v.x;
          raw[4 * k8 + 2 * h + 1] = v.y;
        }
      }
    };
    for (int p = 0; p < P1; ++p) {
      pass<NW>(acc, KB1, load_x, ring, full, empty, it, wg);
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int c = 2 * NW * p + NW * wg + 8 * j + 2 * t4;
        const float b0 = c < L ? bf[c] : 0.f;
        const float b1 = c + 1 < L ? bf[c + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2 v;
          v.x = c < L ? fmaxf(acc[j][2 * h] + b0, 0.f) : 0.f;
          v.y = c + 1 < L ? fmaxf(acc[j][2 * h + 1] + b1, 0.f) : 0.f;
          scr[hidx(p, wg, j, h)] = v;
        }
      }
    }
    hk::named_sync(1, 128 * CONSUMERS);  // the tile's h is in the scratch

    // ---- s = sum_d w_c[d] tanh(z_a + b_a) sigmoid(z_b + b_b), per row
    auto load_h = [&](int kb, float (&raw)[16]) {
#pragma unroll
      for (int k8 = 0; k8 < 4; ++k8) {
        const int c = KB * kb + 8 * k8;  // + 2 t4: this lane's own pair
        const int p = c / (2 * NW), q = (c / NW) & 1, j = (c % NW) / 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = scr[hidx(p, q, j, h)];
          raw[4 * k8 + 2 * h] = v.x;
          raw[4 * k8 + 2 * h + 1] = v.y;
        }
      }
    };
    float sa = 0.f, sb = 0.f;
    for (int p = 0; p < P2; ++p) {
      pass<NW>(acc, KB2, load_h, ring, full, empty, it, wg);
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int d = NW * p + (NW / 2) * wg + 4 * j + t4;
        if (d < Da) {
          const float w = wc[d], a_b = ba[d], b_b = bb[d];
          sa = fmaf(w, tanhf(acc[j][0] + a_b) /
                           (1.f + expf(-(acc[j][1] + b_b))), sa);
          sb = fmaf(w, tanhf(acc[j][2] + a_b) /
                           (1.f + expf(-(acc[j][3] + b_b))), sb);
        }
      }
    }
    sa = hk::quad_sum(sa);
    sb = hk::quad_sum(sb);
    if (t4 == 0) {
      atomicAdd(&srow[wr + g], sa);
      atomicAdd(&srow[wr + g + 8], sb);
    }
    hk::named_sync(1, 128 * CONSUMERS);

    // ---- scores and the online-softmax step over this tile
    if (warp == 0) {
      float v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h, row = row0 + r;
        const bool valid =
            row < N && (mask != nullptr ? mask[row] != 0 : row < n_valid);
        v[h] = valid ? srow[r] + bc[0] : kNegInf;
        if (row < N) scores[row] = v[h];
      }
      float mt = fmaxf(v[0], v[1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_prev = run[0];
      const float m_new = fmaxf(m_prev, mt);
      const float e0 = v[0] > 0.5f * kNegInf ? expf(v[0] - m_new) : 0.f;
      const float e1 = v[1] > 0.5f * kNegInf ? expf(v[1] - m_new) : 0.f;
      e_sm[lane] = e0;
      e_sm[lane + 32] = e1;
      float lsum = e0 + e1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        run[0] = m_new;
        run[1] = run[1] * alpha + lsum;
        run[2] = alpha;
      }
    }
    hk::named_sync(1, 128 * CONSUMERS);

    // ---- acc = acc alpha + e^T h, over the h this thread wrote
    const float ea = e_sm[wr + g], eb = e_sm[wr + g + 8];
    for (int p = 0; p < P1; ++p) {
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const float2 ha = scr[hidx(p, wg, j, 0)], hb = scr[hidx(p, wg, j, 1)];
        float u0 = fmaf(ea, ha.x, eb * hb.x), u1 = fmaf(ea, ha.y, eb * hb.y);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {  // over the 8 row pairs
          u0 += __shfl_xor_sync(0xffffffffu, u0, o);
          u1 += __shfl_xor_sync(0xffffffffu, u1, o);
        }
        const int c = 2 * NW * p + NW * wg + 8 * j + 2 * t4;
        if (g == 0 && c < L) {
          atomicAdd(&tsum[c], u0);
          if (c + 1 < L) atomicAdd(&tsum[c + 1], u1);
        }
      }
    }
    hk::named_sync(1, 128 * CONSUMERS);
    const float alpha = run[2];
    for (int c = tid; c < L; c += 128 * CONSUMERS) {
      acc_s[c] = fmaf(acc_s[c], alpha, tsum[c]);
      tsum[c] = 0.f;
    }
    // the next tile's first barrier orders these before its atomics
  }

  hk::named_sync(1, 128 * CONSUMERS);
  float* out = part + (size_t)blockIdx.x * (2 + L);
  if (tid == 0) {
    out[0] = run[0];
    out[1] = run[1];
  }
  for (int c = tid; c < L; c += 128 * CONSUMERS) out[2 + c] = acc_s[c];
}

}  // namespace tc

// ---------------------------------------------------------------- host
struct Weights {
  const float *wf, *bf, *wa, *ba, *wb, *bb, *wc, *bc;
  const float *wf2, *wz2;  // the tensor-core variant's split weights
};

// the device's SM count and, per variant, CTAs per SM (queried once)
struct DeviceInfo {
  int sms = 0, per_sm[3] = {0, 0, 0};
};

cudaError_t device_info(DeviceInfo** out) {
  static DeviceInfo info[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (info[dev].sms == 0) {
    err = cudaDeviceGetAttribute(&info[dev].sms,
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *out = &info[dev];
  return cudaSuccess;
}

// CTAs per SM of a kernel at ``smem`` bytes, with the attribute set once
template <class K>
cudaError_t per_sm(K kern, int threads, size_t smem, int* slot) {
  if (*slot == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(slot, kern, threads,
                                                        smem);
    if (err != cudaSuccess) return err;
    if (*slot < 1) return cudaErrorInvalidConfiguration;
  }
  return cudaSuccess;
}

// pass-1 CTAs for a bag of N rows: the CTAs resident at once, at most one
// per tile and MAX_PARTS
cudaError_t grid_for(int N, int L, int Da, int* grid) {
  DeviceInfo* info = nullptr;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return err;
  int* slot;
  if (narrow(L, Da)) {
    // the narrow kernel's occupancy depends on L: query at the widest
    slot = &info->per_sm[0];
    err = per_sm(pool_pass1, THREADS, smem_floats(32) * sizeof(float),
                 slot);
  } else if (tc::nw_for(L, Da) == 64) {
    slot = &info->per_sm[1];
    err = per_sm(tc::pool_pass1_tc<64>, tc::THREADS, tc::Cfg<64>::SMEM, slot);
  } else {
    slot = &info->per_sm[2];
    err = per_sm(tc::pool_pass1_tc<128>, tc::THREADS, tc::Cfg<128>::SMEM,
                 slot);
  }
  if (err != cudaSuccess) return err;
  const int tiles = (N + TILE - 1) / TILE;
  int p = *slot * info->sms;
  if (p > tiles) p = tiles;
  if (p > MAX_PARTS) p = MAX_PARTS;
  *grid = p;
  return cudaSuccess;
}

template <int NW>
cudaError_t launch_tc(const float* bag, const uint8_t* mask, int n_valid,
                      int N, int Din, int L, int Da, const Weights& w,
                      float* scores, float* part, float2* scratch, int grid,
                      cudaStream_t s) {
  const int Dk = (Din + 7) / 8 * 8, Lk = (L + 7) / 8 * 8;
  CUtensorMap wfmap, wzmap;
  if (!hk::tensor_map_3d(&wfmap, w.wf2, Dk, L, 2, tc::KB, 2 * NW,
                         CU_TENSOR_MAP_SWIZZLE_128B, true) ||
      !hk::tensor_map_3d(&wzmap, w.wz2, Lk, 2 * Da, 2, tc::KB, 2 * NW,
                         CU_TENSOR_MAP_SWIZZLE_128B, true))
    return cudaErrorInvalidValue;
  tc::pool_pass1_tc<NW><<<grid, tc::THREADS, tc::Cfg<NW>::SMEM, s>>>(
      wfmap, wzmap, bag, mask, n_valid, N, Din, L, Da, w.bf, w.ba, w.bb,
      w.wc, w.bc, scores, part, scratch);
  return cudaGetLastError();
}

cudaError_t run_pass1(const float* bag, const uint8_t* mask, int n_valid,
                      int N, int Din, int L, int Da, const Weights& w,
                      float* scores, float* part, float* scratch, int* parts,
                      cudaStream_t s) {
  if (N <= 0 || Din <= 0 || L <= 0 || Da <= 0 || L > MAX_L)
    return cudaErrorInvalidValue;
  cudaError_t err = grid_for(N, L, Da, parts);
  if (err != cudaSuccess) return err;
  if (narrow(L, Da)) {
    pool_pass1<<<*parts, THREADS, smem_floats(L) * sizeof(float), s>>>(
        bag, mask, n_valid, N, Din, L, Da, w.wf, w.bf, w.wa, w.ba, w.wb,
        w.bb, w.wc, w.bc, scores, part);
    return cudaGetLastError();
  }
  if (!w.wf2 || !w.wz2 || !scratch) return cudaErrorInvalidValue;
  float2* scr = reinterpret_cast<float2*>(scratch);
  if (tc::nw_for(L, Da) == 64)
    return launch_tc<64>(bag, mask, n_valid, N, Din, L, Da, w, scores, part,
                         scr, *parts, s);
  return launch_tc<128>(bag, mask, n_valid, N, Din, L, Da, w, scores, part,
                        scr, *parts, s);
}

}  // namespace

extern "C" {

int gated_pool_tile(void) { return TILE; }

int gated_pool_max_parts(void) { return MAX_PARTS; }

// Which pass 1 takes a head (L, D_att): 1 the tensor-core variant (which
// needs the split weights and a scratch), 0 the narrow one, -1 none (L past
// MAX_L).
int gated_pool_variant(int L, int Da) {
  if (L <= 0 || Da <= 0 || L > MAX_L) return -1;
  return narrow(L, Da) ? 0 : 1;
}

int gated_pool_max_l(void) { return MAX_L; }

// float2s of h scratch the tensor-core variant needs for a bag of N rows
// (0 for the narrow variant); -1 on a CUDA error
long long gated_pool_scratch_float2(int N, int L, int Da) {
  if (gated_pool_variant(L, Da) != 1) return 0;
  int grid = 0;
  if (grid_for(N, L, Da, &grid) != cudaSuccess) return -1;
  return (long long)grid * tc::scratch_float2(L, tc::nw_for(L, Da));
}

const char* gated_pool_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// bag [N, Din] f32; mask [N] uint8 or null (then rows < n_valid are valid);
// weights f32 in [in, out] layout: wf [Din, L], wa/wb [L, Da], wc [Da],
// wcls [L, C]; for the tensor-core variant also wf2 [2, L, Dk] and wz2
// [2, 2 Da, Lk] (gated_attention_pool.py _split_weights) and a scratch of
// gated_pool_scratch_float2 float2s. Outputs: scores [N], logits [C]; part
// scratch [min(tiles, max_parts), 2 + L]. Returns the first CUDA error.
int gated_pool_forward(const float* bag, const uint8_t* mask, int n_valid,
                       int N, int Din, int L, int Da, int C, const float* wf,
                       const float* bf, const float* wa, const float* ba,
                       const float* wb, const float* bb, const float* wc,
                       const float* bc, const float* wcls, const float* bcls,
                       const float* wf2, const float* wz2, float* scores,
                       float* part, float* scratch, float* logits,
                       void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Weights w{wf, bf, wa, ba, wb, bb, wc, bc, wf2, wz2};
  int parts = 0;
  cudaError_t err = run_pass1(bag, mask, n_valid, N, Din, L, Da, w, scores,
                              part, scratch, &parts, s);
  if (err != cudaSuccess) return (int)err;
  pool_combine<<<1, THREADS, L * sizeof(float), s>>>(
      part, parts, L, C, wcls, bcls, logits, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// The shard-local partial of the same pooling (the TPU kernel's partial_out
// mode): acc [L], the weighted sum of h at the bag's score max, unnormalised;
// ml = (m, l), that max (-1e30 when no row is valid) and the sum of the
// weights (0 then). Weights, scores and scratch as gated_pool_forward.
int gated_pool_partial(const float* bag, const uint8_t* mask, int n_valid,
                       int N, int Din, int L, int Da, const float* wf,
                       const float* bf, const float* wa, const float* ba,
                       const float* wb, const float* bb, const float* wc,
                       const float* bc, const float* wf2, const float* wz2,
                       float* scores, float* part, float* scratch,
                       float* acc, float* ml, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Weights w{wf, bf, wa, ba, wb, bb, wc, bc, wf2, wz2};
  int parts = 0;
  cudaError_t err = run_pass1(bag, mask, n_valid, N, Din, L, Da, w, scores,
                              part, scratch, &parts, s);
  if (err != cudaSuccess) return (int)err;
  pool_combine<<<1, THREADS, 0, s>>>(part, parts, L, 0, nullptr, nullptr,
                                     nullptr, acc, ml);
  return (int)cudaGetLastError();
}

}  // extern "C"
