// Device code of one pre-norm ViT block for Hopper (sm_90a), shared by the
// per-block kernels (fused_block.cu, seven launches per block) and the
// whole-network kernel (fused_network.cu, every block of the stack in one
// cooperative launch).
//
// Each piece is written for one CTA's share of a stage, so the per-block
// kernels call it once per CTA and the persistent kernel calls it in
// grid-stride loops:
//
//   layernorm_rows2 one warp, two rows: y = bf16(LN(x)), f32 statistics;
//                   optionally copies the rows to an f32 buffer
//   gemm_tiles      GEMM_THREADS threads walk 128 x 128 tiles of A . W^T
//                   (W in torch Linear [out, in] layout, optionally one
//                   slice of a [T, N, K] stack) with one of four epilogues:
//                   QKV (bias; q scaled in f32 before its bf16 store,
//                   head-major [3, B, H, n_pad, hd]), PROJ (x2 = (x + acc)
//                   + b in f32, x bf16 or f32), FC1 (bf16(GELU_erf(acc +
//                   b))), FC2 ((x2 + acc) + b, stored bf16 or f32)
//   attention_head  one (image, head): K and V copied into shared memory
//                   once (rows hd + 8 apart: conflict-free ldmatrix); every
//                   warp takes 16-query tiles in turn; f32 scores in
//                   mma.sync registers, keys >= n_valid at -1e30, two passes
//                   (f32 row max and sum, then P = bf16(e / sum e) and O +=
//                   P . V in f32) in 64- and 32-key slices, then 16-key
//                   slices to n_valid rounded to 16 -> bf16 [B, n_pad, D];
//                   e = exp2(s log2(e) - max s log2(e)) on the
//                   special-function unit, 1 / sum e folded into the
//                   exponent (hopper.cuh's softmax step)
//
// The GEMM is warp-specialised. One producer warp copies 128 x 64 bf16
// tiles of A and W with TMA into a ring of GEMM_STAGES stages (128-byte
// swizzle, the layout wgmma reads), each guarded by a "full" and an
// "empty" mbarrier. Two consumer warpgroups each run wgmma m64n128k16 (bf16
// in, f32 accumulate in registers) on 64 rows of the tile and store the
// epilogue straight from the accumulators as bf16x2 / float2 pairs. TMA
// fills rows past M or N and columns past K with zeros, which covers every
// ragged edge (M = B * n_pad, N = 288 at D = 96, K = 96). The PTX, the TMA
// map encoder and the softmax step are in hopper.cuh, which the attention
// kernels (flash_attention.cu) share.
//
// Pointers carry no __restrict__: in the persistent kernel the same buffers
// are written in one stage and read in the next, so no load may go through
// the read-only (non-coherent) cache.
#pragma once

#include "hopper.cuh"

namespace vit {

using namespace hk;

// ---------------------------------------------------------------- layernorm
constexpr int LN_MAX_PER_LANE = 12;  // D <= 384

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// four consecutive elements of a row as f32 (16-byte f32 or 8-byte bf16
// load); ``p`` is 4-element aligned
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// One warp, two rows of x [M, D] (r0, and r1 unless it is >= M):
// y = bf16((x - mean) * rsqrt(var + eps) * g + b) with f32 statistics; with
// ``copy`` set each row is also stored there as f32. Each lane holds four
// consecutive columns per 128, so a warp keeps both rows' loads in flight
// at once. The only LayerNorm of both kernels, so their statistics agree
// bit for bit.
template <typename TIn>
__device__ __forceinline__ void layernorm_rows2(const TIn* x, const float* g,
                                                const float* b, bf16* y,
                                                int D, float eps, int r0,
                                                int r1, int M, float* copy) {
  constexpr int V = LN_MAX_PER_LANE / 4;  // 4-column groups per lane
  const int lane = threadIdx.x & 31;
  float4 v[2][V];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = r ? r1 : r0;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = 4 * (lane + 32 * i);
      v[r][i] = m < M && c < D ? load4(x + (size_t)m * D + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = r ? r1 : r0;
    if (m >= M) continue;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) s += (v[r][i].x + v[r][i].y) + (v[r][i].z + v[r][i].w);
    const float mu = warp_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (4 * (lane + 32 * i) < D) {
        const float a0 = v[r][i].x - mu, a1 = v[r][i].y - mu;
        const float a2 = v[r][i].z - mu, a3 = v[r][i].w - mu;
        q += a0 * a0 + a1 * a1 + a2 * a2 + a3 * a3;
      }
    }
    const float rstd = rsqrtf(warp_sum(q) / D + eps);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = 4 * (lane + 32 * i);
      if (c < D) {
        const float4 gg = *reinterpret_cast<const float4*>(g + c);
        const float4 bb = *reinterpret_cast<const float4*>(b + c);
        __nv_bfloat162 lo = __floats2bfloat162_rn(
            (v[r][i].x - mu) * rstd * gg.x + bb.x,
            (v[r][i].y - mu) * rstd * gg.y + bb.y);
        __nv_bfloat162 hi = __floats2bfloat162_rn(
            (v[r][i].z - mu) * rstd * gg.z + bb.z,
            (v[r][i].w - mu) * rstd * gg.w + bb.w);
        uint2 pk;
        pk.x = *reinterpret_cast<uint32_t*>(&lo);
        pk.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(y + (size_t)m * D + c) = pk;
        if (copy)
          *reinterpret_cast<float4*>(copy + (size_t)m * D + c) = v[r][i];
      }
    }
  }
}

// ---------------------------------------------------------------- GEMM
// C[M, N] = A[M, K] . W[N, K]^T on 128 x 128 tiles, K in steps of 64
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int GEMM_STAGES = 3;
constexpr int GEMM_CONSUMERS = 2;                    // warpgroups, 64 rows
constexpr int GEMM_THREADS = 128 * GEMM_CONSUMERS + 32;  // + producer warp
constexpr int PRODUCER_WARP = 4 * GEMM_CONSUMERS;
constexpr uint32_t TILE_BYTES = BM * BK * sizeof(bf16);  // 16 KB, = BN rows
constexpr uint32_t STAGE_BYTES = 2 * TILE_BYTES;         // A and W tiles
// the ring, plus slack to align the dynamic base to the 1024 bytes the
// 128-byte swizzle pattern repeats over
constexpr size_t GEMM_SMEM = (size_t)GEMM_STAGES * STAGE_BYTES + 1024;

// The copy ring's barriers, the tile each stage holds, and this thread's
// count of stages through it. Producer and consumers walk the same stages,
// so their counts agree at every GEMM boundary and the ring carries over
// from one GEMM to the next.
struct Ring {
  uint64_t* full;   // [GEMM_STAGES]: the TMA bytes of a stage landed
  uint64_t* empty;  // [GEMM_STAGES]: every consumer warp is done with it
  int* tile;        // [GEMM_STAGES]: its tile, or -1: no more tiles
  uint32_t it;
};

// thread 0 initialises the barriers; all threads must call it.
// ``bars``: 2 GEMM_STAGES, ``slots``: GEMM_STAGES, both in shared memory.
__device__ __forceinline__ Ring ring_init(uint64_t* bars, int* slots) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < GEMM_STAGES; ++s) {
      mbar_init(&bars[s], 1);
      mbar_init(&bars[GEMM_STAGES + s], 4 * GEMM_CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return Ring{bars, bars + GEMM_STAGES, slots, 0u};
}

// Which units of a GEMM's tiles a CTA takes: first, first + step, ... or,
// with a counter, whatever atomicAdd(counter, 1) hands out, so CTAs that
// run ahead take more.
struct Sched {
  int first, step;
  int* counter;
};

enum Epi { EPI_QKV = 0, EPI_PROJ = 1, EPI_FC1 = 2, EPI_FC2 = 3 };

struct EpiArgs {
  const float* bias;       // [N]
  bf16* qkv;               // EPI_QKV: [3, B, H, n_pad, hd]
  int batch, n_pad, heads, hd, dim;
  float scale;
  const bf16* res_bf16;    // EPI_PROJ: residual x [M, N] when bf16
  const float* res_f32;    // EPI_PROJ: residual x when f32; EPI_FC2: x2
  float* out_f32;          // EPI_PROJ: x2; EPI_FC2: out when f32
  bf16* out_bf16;          // EPI_FC1: h; EPI_FC2: out when bf16
};

__device__ __forceinline__ float gelu_erf(float v) {
  return v * 0.5f * (1.f + erff(v * 0.70710678118654752f));
}

// The accumulators of one consumer thread: rows r0 and r0 + 8, columns
// n0 + 8 j + 2 (lane % 4) and the next (d[j][0..1] on row r0, d[j][2..3] on
// row r0 + 8). N is even, so a pair never straddles the edge.
template <int EPI>
__device__ __forceinline__ void store_tile(const EpiArgs& ep,
                                           const float (&d)[16][4], int M,
                                           int N, int r0, int n0) {
  const int cq = 2 * (threadIdx.x & 3);
  size_t qrow[2] = {0, 0};  // QKV: token offset of each row in its head
  if (EPI == EPI_QKV) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + 8 * h;
      const int b = m / ep.n_pad;
      qrow[h] = (size_t)b * ep.heads * ep.n_pad * ep.hd +
                (size_t)(m - b * ep.n_pad) * ep.hd;
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + 8 * j + cq;
    if (n >= N) break;
    const float2 bias = *reinterpret_cast<const float2*>(ep.bias + n);
    size_t qcol = 0;
    bool is_q = false;
    if (EPI == EPI_QKV) {  // which of q, k, v; head; lane of the head
      const int which = n / ep.dim;
      const int rem = n - which * ep.dim;
      const int h = rem / ep.hd;
      qcol = (size_t)which * ep.batch * ep.heads * ep.n_pad * ep.hd +
             (size_t)h * ep.n_pad * ep.hd + (rem - h * ep.hd);
      is_q = which == 0;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + 8 * h;
      if (m >= M) continue;
      const float a0 = d[j][2 * h], a1 = d[j][2 * h + 1];
      const size_t idx = (size_t)m * N + n;
      if (EPI == EPI_QKV) {
        float v0 = a0 + bias.x, v1 = a1 + bias.y;
        if (is_q) {  // q scaled in f32 before the bf16 store
          v0 *= ep.scale;
          v1 *= ep.scale;
        }
        store_pair(ep.qkv + qrow[h] + qcol, v0, v1);
      } else if (EPI == EPI_PROJ) {
        float2 r;
        if (ep.res_bf16)
          r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(ep.res_bf16 + idx));
        else
          r = *reinterpret_cast<const float2*>(ep.res_f32 + idx);
        *reinterpret_cast<float2*>(ep.out_f32 + idx) =
            make_float2((r.x + a0) + bias.x, (r.y + a1) + bias.y);
      } else if (EPI == EPI_FC1) {
        store_pair(ep.out_bf16 + idx, gelu_erf(a0 + bias.x),
                   gelu_erf(a1 + bias.y));
      } else {
        const float2 r = *reinterpret_cast<const float2*>(ep.res_f32 + idx);
        const float v0 = (r.x + a0) + bias.x, v1 = (r.y + a1) + bias.y;
        if (ep.out_bf16)
          store_pair(ep.out_bf16 + idx, v0, v1);
        else
          *reinterpret_cast<float2*>(ep.out_f32 + idx) = make_float2(v0, v1);
      }
    }
  }
}

// The 128 x 128 tiles of C = A . W[t]^T (tile = m-block * n-blocks +
// n-block), taken as ``sched`` says. ``amap``: A [M, K] bf16 as a [1, M, K]
// TMA map; ``wmap``: W [T, N, K] bf16; boxes 64 x 128. The producer tells
// the consumers each stage's tile through the ring, and ends the GEMM with
// one stage of tile -1. All GEMM_THREADS threads call it; ``tiles`` is the
// 1024-aligned ring.
template <int EPI>
__device__ __forceinline__ void gemm_tiles(const CUtensorMap* amap,
                                           const CUtensorMap* wmap, int t,
                                           int M, int N, int K,
                                           const EpiArgs& ep,
                                           unsigned char* tiles, Ring& ring,
                                           Sched sched) {
  const int tn = (N + BN - 1) / BN;
  const int n_tiles = (M + BM - 1) / BM * tn;
  const int ksteps = (K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // shared memory another stage wrote is about to take TMA writes
  fence_proxy_async();
  __syncthreads();
  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      for (int i = 0;; ++i) {
        int tile = sched.counter ? atomicAdd(sched.counter, 1)
                                 : sched.first + i * sched.step;
        const bool done = tile >= n_tiles;
        if (done) tile = -1;
        const int m0 = (tile / tn) * BM, n0 = (tile % tn) * BN;
        for (int k = 0; k < (done ? 1 : ksteps); ++k, ++ring.it) {
          const int s = ring.it % GEMM_STAGES;
          const uint32_t ph = (ring.it / GEMM_STAGES) & 1;
          mbar_wait(&ring.empty[s], ph ^ 1);  // first round passes
          ring.tile[s] = tile;
          if (done) {
            mbar_arrive(&ring.full[s]);
            break;
          }
          mbar_expect_tx(&ring.full[s], STAGE_BYTES);
          unsigned char* st = tiles + s * STAGE_BYTES;
          tma_load_3d(st, amap, &ring.full[s], k * BK, m0, 0);
          tma_load_3d(st + TILE_BYTES, wmap, &ring.full[s], k * BK, n0, t);
        }
        if (done) {
          ++ring.it;
          break;
        }
      }
    }
    __syncwarp();
    return;
  }
  const int wg = warp >> 2;  // consumer warpgroup: rows wg * 64 of a tile
  float d[BN / 8][4];
  for (;;) {
    int s = ring.it % GEMM_STAGES;
    mbar_wait(&ring.full[s], (ring.it / GEMM_STAGES) & 1);
    const int tile = ring.tile[s];
    if (tile < 0) {
      if (lane == 0) mbar_arrive(&ring.empty[s]);
      ++ring.it;
      break;
    }
    const int m0 = (tile / tn) * BM, n0 = (tile % tn) * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
    int prev = -1;
    for (int k = 0; k < ksteps; ++k, ++ring.it) {
      s = ring.it % GEMM_STAGES;
      if (k > 0) mbar_wait(&ring.full[s], (ring.it / GEMM_STAGES) & 1);
      unsigned char* st = tiles + s * STAGE_BYTES;
      const uint64_t da = swz_desc(st + wg * 64 * 128, 128);
      const uint64_t db = swz_desc(st + TILE_BYTES, 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // 32 bytes along K per step
        wgmma_m64n128k16(d, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      // keep this step's products in flight; the previous step's are done
      wgmma_wait<1>();
      if (prev >= 0 && lane == 0) mbar_arrive(&ring.empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&ring.empty[prev]);
    store_tile<EPI>(ep, d, M, N, m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2),
                    n0);
  }
}

// ---------------------------------------------------------------- host
// A bf16 tensor [depth, rows, cols] (cols contiguous) as a TMA map whose
// boxes are the GEMM's 64-column x 128-row tiles of one depth slice, with
// the 128-byte swizzle wgmma reads and zeros outside the tensor. False when
// the driver refuses it.
inline bool tile_map(CUtensorMap* map, const void* ptr, int cols, int rows,
                     int depth) {
  return tensor_map_3d(map, ptr, cols, rows, depth, BK, BM,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---------------------------------------------------------------- attention
// K and V rows held in shared memory: n_pad rounded up to the 64-key chunk
__host__ __device__ inline int att_rows(int n_pad) {
  return (n_pad + 63) / 64 * 64;
}

// dynamic shared memory of attention_head: K and V [att_rows][hd + 8] bf16
__host__ __device__ inline size_t att_smem(int n_pad, int hd) {
  return 2 * (size_t)att_rows(n_pad) * (hd + 8) * sizeof(bf16);
}

// this warp's 16 query rows [r0, r0 + 16) of q [n, HD] as m16n8k16 A
// fragments (rows past n zero)
template <int HD>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[HD / 16][4],
                                             const bf16* q, int r0, int n) {
  const int lane = threadIdx.x & 31;
  const int ra = r0 + (lane >> 2), rb = ra + 8, cq = 2 * (lane & 3);
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    const int c = kc * 16 + cq;
    qa[kc][0] = ra < n ? *reinterpret_cast<const uint32_t*>(
                             q + (size_t)ra * HD + c) : 0u;
    qa[kc][1] = rb < n ? *reinterpret_cast<const uint32_t*>(
                             q + (size_t)rb * HD + c) : 0u;
    qa[kc][2] = ra < n ? *reinterpret_cast<const uint32_t*>(
                             q + (size_t)ra * HD + c + 8) : 0u;
    qa[kc][3] = rb < n ? *reinterpret_cast<const uint32_t*>(
                             q + (size_t)rb * HD + c + 8) : 0u;
  }
}

// S[16 x 8 NT] = Q . K[key0 .. key0 + 8 NT)^T for one warp's 16 rows
template <int HD, int NT>
__device__ __forceinline__ void qk_scores(float (&s)[NT][4],
                                          const uint32_t (&qa)[HD / 16][4],
                                          const bf16* Ks, int key0) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const int r = key0 + nt * 8 + (lane & 7);
#pragma unroll
    for (int kc = 0; kc < HD / 16; kc += 2) {
      uint32_t b[4];  // b0, b1 of columns kc and kc + 1
      ldmatrix_x4(b, Ks + r * LD + 8 * (2 * kc + (lane >> 3)));
      mma16816(s[nt], qa[kc], b[0], b[1]);
      mma16816(s[nt], qa[kc + 1], b[2], b[3]);
    }
  }
}

// pass 1 over keys [k0, k0 + 8 NT) of one warp's 16 rows
template <int HD, int NT>
__device__ __forceinline__ void stats_slice(float (&m)[2], float (&l)[2],
                                            const uint32_t (&qa)[HD / 16][4],
                                            const bf16* Ks, int k0,
                                            int n_valid, float c) {
  float s[NT][4], alpha[2];
  qk_scores<HD, NT>(s, qa, Ks, k0);
  softmax_step<NT>(s, m, l, alpha, k0, n_valid, c);
}

// pass 2 over keys [k0, k0 + 8 NT), NT 2 or 4, of one warp's 16 rows:
// P = bf16(e / sum e) and O += P . V in f32
template <int HD, int NT>
__device__ __forceinline__ void pv_slice(float (&o)[HD / 8][4],
                                         const uint32_t (&qa)[HD / 16][4],
                                         const bf16* Ks, const bf16* Vs,
                                         int k0, int n_valid, float c,
                                         const float (&mm)[2]) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31;
  float s[NT][4];
  qk_scores<HD, NT>(s, qa, Ks, k0);
  if (k0 + 8 * NT > n_valid) mask_keys<NT>(s, k0, n_valid);
  uint32_t p[2 * NT];
  pack_p<NT>(p, s, mm, c);
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const int vr = k0 + 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int dn = 0; dn < HD / 8; dn += 2) {
      uint32_t vb[4];  // b0, b1 of d-tiles dn and dn + 1
      ldmatrix_x4_trans(vb, Vs + vr * LD + 8 * (dn + (lane >> 4)));
      mma16816(o[dn], &p[4 * kk], vb[0], vb[1]);
      mma16816(o[dn + 1], &p[4 * kk], vb[2], vb[3]);
    }
  }
}

// O of one warp's 16 query rows against the first ceil(n_valid / 16) * 16
// rows of K and V (rows past N must be zeros): pass 1 in 64-key slices,
// pass 2 in 32-key slices, each then in 16-key slices to the end
template <int HD>
__device__ __forceinline__ void attend_rows(float (&o)[HD / 8][4],
                                            const uint32_t (&qa)[HD / 16][4],
                                            const bf16* Ks, const bf16* Vs,
                                            int n_valid, float c) {
  const int rows = (n_valid + 15) / 16 * 16;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, mm[2];
  int k0 = 0;
  for (; k0 + 64 <= rows; k0 += 64)
    stats_slice<HD, 8>(m, l, qa, Ks, k0, n_valid, c);
  for (; k0 < rows; k0 += 16)
    stats_slice<HD, 2>(m, l, qa, Ks, k0, n_valid, c);
  normaliser(mm, m, l);
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  for (k0 = 0; k0 + 32 <= rows; k0 += 32)
    pv_slice<HD, 4>(o, qa, Ks, Vs, k0, n_valid, c, mm);
  if (k0 < rows) pv_slice<HD, 2>(o, qa, Ks, Vs, k0, n_valid, c, mm);
}

// Head h of image b: any blockDim.x that is a multiple of 32, att_smem
// bytes of dynamic shared memory at ``smem``. q (already scaled), k, v from
// the head-major qkv [3, B, H, n_pad, HD]; out [B, n_pad, H * HD]. K and V
// are copied in once (rows padded to hd + 8); every warp then takes
// 16-query tiles in turn through attend_rows.
template <int HD>
__device__ __forceinline__ void attention_head(const bf16* qkv, bf16* out,
                                               int B, int H, int n_pad,
                                               int n_valid, int h, int b,
                                               unsigned char* smem) {
  constexpr int LD = HD + 8;   // K and V rows: conflict-free ldmatrix
  constexpr int VPR = HD / 8;  // 16-byte vectors per row
  const int rows = (n_valid + 15) / 16 * 16;  // keys past this are never read
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + att_rows(n_pad) * LD;
  const size_t head = (size_t)n_pad * HD;
  const bf16* qg = qkv + ((size_t)(0 * B + b) * H + h) * head;
  const bf16* kg = qkv + ((size_t)(1 * B + b) * H + h) * head;
  const bf16* vg = qkv + ((size_t)(2 * B + b) * H + h) * head;

  __syncthreads();  // every warp is done with the previous head's K and V
  for (int e = threadIdx.x; e < rows * VPR; e += blockDim.x) {
    const int r = e / VPR, c = (e % VPR) * 8;
    const bool in = r < n_pad;  // rows past n_pad load zeros
    const size_t off = in ? (size_t)r * HD + c : 0;
    cp_async16(Ks + r * LD + c, kg + off, in);
    cp_async16(Vs + r * LD + c, vg + off, in);
  }
  cp_async_wait_all();
  __syncthreads();

  const int D = H * HD;
  bf16* ob = out + (size_t)b * n_pad * D + h * HD;  // heads interleaved
  for (int r0 = (threadIdx.x >> 5) * 16; r0 < n_pad;
       r0 += (blockDim.x >> 5) * 16) {
    uint32_t qa[HD / 16][4];
    load_q_frags<HD>(qa, qg, r0, n_pad);
    float o[HD / 8][4];
    attend_rows<HD>(o, qa, Ks, Vs, n_valid, kLog2e);
    store_o<HD>(ob, D, o, r0, n_pad);
  }
}

}  // namespace vit
