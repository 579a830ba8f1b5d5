// Device code of one pre-norm ViT block, shared by the per-block kernels
// (fused_block.cu, seven launches per block) and the whole-network kernel
// (fused_network.cu, every block of the stack in one cooperative launch).
//
// Each piece is written for one CTA's share of a stage, so the per-block
// kernels call it once per CTA (tile from blockIdx) and the persistent
// kernel calls it in grid-stride loops:
//
//   layernorm_row   one warp, one row: y = bf16(LN(x)), f32 statistics;
//                   optionally copies the row to an f32 buffer
//   gemm_tile       256 threads, one 128 x 128 tile of A . W^T (W in torch
//                   Linear [out, in] layout) with one of four epilogues:
//                   QKV (bias; q scaled in f32 before its bf16 store,
//                   head-major [3, B, H, n_pad, hd]), PROJ (x2 = (x + acc)
//                   + b in f32, x bf16 or f32), FC1 (bf16(GELU_erf(acc +
//                   b))), FC2 ((x2 + acc) + b, stored bf16 or f32)
//   attention_tile  one (image, head, 64-query tile): K and V in shared
//                   memory, f32 scores, keys >= n_valid at -1e30, f32
//                   softmax, P = bf16(e / sum e), O = P . V in f32 -> bf16
//                   [B, n_pad, D]. Warps 0-3 compute; the CTA's other
//                   warps only help load K, V and Q.
//
// Every product is a WMMA bf16 16x16x16 fragment with f32 accumulation.
// Pointers carry no __restrict__ here: in the persistent kernel the same
// buffers are written in one stage and read in the next, so no load may go
// through the read-only (non-coherent) cache.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace vit {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------- layernorm
constexpr int LN_MAX_PER_LANE = 12;  // D <= 384

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one warp: yr = bf16((xr - mean) * rsqrt(var + eps) * g + b), f32 math;
// with ``copy`` set the row is also stored there as f32
template <typename TIn>
__device__ __forceinline__ void layernorm_row(const TIn* xr, const float* g,
                                              const float* b, bf16* yr, int D,
                                              float eps, float* copy) {
  const int lane = threadIdx.x & 31;
  float v[LN_MAX_PER_LANE];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_PER_LANE; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < D ? to_f32(xr[c]) : 0.f;
    s += v[i];
  }
  const float mu = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_PER_LANE; ++i) {
    const int c = lane + 32 * i;
    if (c < D) q += (v[i] - mu) * (v[i] - mu);
  }
  const float rstd = rsqrtf(warp_sum(q) / D + eps);
#pragma unroll
  for (int i = 0; i < LN_MAX_PER_LANE; ++i) {
    const int c = lane + 32 * i;
    if (c < D) {
      yr[c] = __float2bfloat16((v[i] - mu) * rstd * g[c] + b[c]);
      if (copy) copy[c] = v[i];
    }
  }
}

// ---------------------------------------------------------------- GEMM
// C[M, N] = A[M, K] . W[N, K]^T, 128 x 128 CTA tile, 8 warps as 2 x 4, each
// warp 64 x 32 = 4 x 2 WMMA fragments. K is a multiple of BK.
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int GEMM_THREADS = 256;
constexpr int SK = BK + 8;   // bf16 row stride of the A and W tiles
constexpr int SC = BN + 4;   // f32 row stride of the staged C tile
constexpr size_t GEMM_SMEM =
    (size_t)BM * SC * sizeof(float) > (size_t)2 * BM * SK * sizeof(bf16)
        ? (size_t)BM * SC * sizeof(float)
        : (size_t)2 * BM * SK * sizeof(bf16);

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

template <int EPI>
__device__ __forceinline__ void epilogue(const EpiArgs& ep, int m, int n,
                                         int N, float acc) {
  const size_t idx = (size_t)m * N + n;
  if (EPI == EPI_QKV) {
    float v = acc + ep.bias[n];
    const int which = n / ep.dim;
    const int rem = n - which * ep.dim;
    const int h = rem / ep.hd;
    const int d = rem - h * ep.hd;
    const int b = m / ep.n_pad;
    const int t = m - b * ep.n_pad;
    if (which == 0) v *= ep.scale;  // q scaled in f32 before the bf16 store
    ep.qkv[((((size_t)which * ep.batch + b) * ep.heads + h) * ep.n_pad + t) *
               ep.hd + d] = __float2bfloat16(v);
  } else if (EPI == EPI_PROJ) {
    const float res = ep.res_bf16 ? __bfloat162float(ep.res_bf16[idx])
                                  : ep.res_f32[idx];
    ep.out_f32[idx] = (res + acc) + ep.bias[n];
  } else if (EPI == EPI_FC1) {
    const float v = acc + ep.bias[n];
    ep.out_bf16[idx] =
        __float2bfloat16(v * 0.5f * (1.f + erff(v * 0.70710678118654752f)));
  } else {
    const float v = (ep.res_f32[idx] + acc) + ep.bias[n];
    if (ep.out_bf16)
      ep.out_bf16[idx] = __float2bfloat16(v);
    else
      ep.out_f32[idx] = v;
  }
}

// one 128 x 128 output tile at (m0, n0); needs GEMM_THREADS threads and
// GEMM_SMEM bytes of dynamic shared memory
template <int EPI>
__device__ __forceinline__ void gemm_tile(const bf16* A, const bf16* W, int M,
                                          int N, int K, const EpiArgs& ep,
                                          int m0, int n0,
                                          unsigned char* smem) {
  bf16* As = reinterpret_cast<bf16*>(smem);   // [BM][SK]
  bf16* Ws = As + BM * SK;                    // [BN][SK]
  float* Cs = reinterpret_cast<float*>(smem); // [BM][SC], after the K loop

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // 128 rows x 32 bf16 = 512 16-byte vectors per tile, 2 per thread;
    // rows past M or N load zeros
    for (int v = tid; v < BM * (BK / 8); v += GEMM_THREADS) {
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      uint4 a = make_uint4(0, 0, 0, 0), w = make_uint4(0, 0, 0, 0);
      if (m0 + r < M)
        a = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + c);
      if (n0 + r < N)
        w = *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(As + r * SK + c) = a;
      *reinterpret_cast<uint4*>(Ws + r * SK + c) = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * SK + kk, SK);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Ws + (wn + 16 * j) * SK + kk, SK);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * SC + wn + 16 * j,
                              acc[i][j], SC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += GEMM_THREADS) {
    const int r = e / BN, c = e % BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) epilogue<EPI>(ep, m, n, N, Cs[r * SC + c]);
  }
}

// ---------------------------------------------------------------- attention
constexpr int ATT_WARPS = 4;          // 16 query rows each
constexpr int ATT_QT = 16 * ATT_WARPS;

__host__ __device__ inline size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

struct AttLayout {
  size_t k, v, q, s, p, total;
};

// f32 floats per warp for the score tile [16][nk+4], which is reused for
// the O tile [16][hd+4]
__host__ __device__ inline size_t att_s_warp(int nk, int hd) {
  return align128((size_t)16 * (nk > hd ? nk + 4 : hd + 4) * sizeof(float));
}

// shared-memory carve-up for one CTA: K, V [nk][hd+8] bf16, Q [64][hd+8]
// bf16, per-warp scores (and O) f32 and probabilities [16][nk+8] bf16
__host__ __device__ inline AttLayout att_layout(int nk, int hd) {
  AttLayout L;
  const size_t kv = align128((size_t)nk * (hd + 8) * sizeof(bf16));
  L.k = 0;
  L.v = kv;
  L.q = 2 * kv;
  L.s = L.q + align128((size_t)ATT_QT * (hd + 8) * sizeof(bf16));
  L.p = L.s + ATT_WARPS * att_s_warp(nk, hd);
  const size_t p_warp = align128((size_t)16 * (nk + 8) * sizeof(bf16));
  L.total = L.p + ATT_WARPS * p_warp;
  return L;
}

// keys padded to a multiple of 16
__host__ __device__ inline int att_nk(int n_pad) {
  return (n_pad + 15) / 16 * 16;
}

// the 64-query tile q0 of head h of image b; any blockDim.x >= 128 (a
// multiple of 32), att_layout(nk, HD).total bytes of dynamic shared memory
template <int HD>
__device__ __forceinline__ void attention_tile(const bf16* qkv, bf16* out,
                                               int B, int H, int n_pad,
                                               int n_valid, int nk, int q0,
                                               int h, int b,
                                               unsigned char* smem) {
  constexpr int LDK = HD + 8;
  const AttLayout L = att_layout(nk, HD);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  const int lds = nk + 4, ldp = nk + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = blockDim.x;

  const size_t head = (size_t)n_pad * HD;
  const bf16* qg = qkv + ((size_t)(0 * B + b) * H + h) * head;
  const bf16* kg = qkv + ((size_t)(1 * B + b) * H + h) * head;
  const bf16* vg = qkv + ((size_t)(2 * B + b) * H + h) * head;

  constexpr int VPR = HD / 8;  // 16-byte vectors per row
  for (int e = tid; e < nk * VPR; e += nthreads) {
    const int r = e / VPR, c = (e % VPR) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (r < n_pad) {
      kv = *reinterpret_cast<const uint4*>(kg + (size_t)r * HD + c);
      vv = *reinterpret_cast<const uint4*>(vg + (size_t)r * HD + c);
    }
    *reinterpret_cast<uint4*>(Ks + r * LDK + c) = kv;
    *reinterpret_cast<uint4*>(Vs + r * LDK + c) = vv;
  }
  for (int e = tid; e < ATT_QT * VPR; e += nthreads) {
    const int r = e / VPR, c = (e % VPR) * 8;
    uint4 qv = make_uint4(0, 0, 0, 0);
    if (q0 + r < n_pad)
      qv = *reinterpret_cast<const uint4*>(qg + (size_t)(q0 + r) * HD + c);
    *reinterpret_cast<uint4*>(Qs + r * LDK + c) = qv;
  }
  __syncthreads();
  if (warp >= ATT_WARPS) return;  // from here on warp-local work only

  float* Sw = reinterpret_cast<float*>(smem + L.s + warp * att_s_warp(nk, HD));
  bf16* Pw = reinterpret_cast<bf16*>(
      smem + L.p + warp * align128((size_t)16 * ldp * sizeof(bf16)));

  // S = Q_w . K^T for this warp's 16 query rows
  const bf16* Qw = Qs + warp * 16 * LDK;
  for (int kb = 0; kb < nk / 16; ++kb) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
    wmma::fill_fragment(s, 0.f);
#pragma unroll
    for (int kd = 0; kd < HD; kd += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, Qw + kd, LDK);
      wmma::load_matrix_sync(fb, Ks + kb * 16 * LDK + kd, LDK);
      wmma::mma_sync(s, fa, fb, s);
    }
    wmma::store_matrix_sync(Sw + kb * 16, s, lds, wmma::mem_row_major);
  }
  __syncwarp();

  // f32 softmax over the key axis; keys >= n_valid (padding) at -1e30
  for (int r = 0; r < 16; ++r) {
    float* srow = Sw + r * lds;
    float mx = kNegInf;
    for (int j = lane; j < nk; j += 32) {
      const float v = j < n_valid ? srow[j] : kNegInf;
      srow[j] = v;
      mx = fmaxf(mx, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(srow[j] - mx);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    bf16* prow = Pw + r * ldp;
    for (int j = lane; j < nk; j += 32)
      prow[j] = __float2bfloat16(srow[j] / sum);
  }
  __syncwarp();

  // O_w = P_w . V, staged as f32 [16][HD+4] in the (now free) score tile
  constexpr int LDO = HD + 4;
#pragma unroll
  for (int db = 0; db < HD / 16; ++db) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
    wmma::fill_fragment(o, 0.f);
    for (int kb = 0; kb < nk / 16; ++kb) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, Pw + kb * 16, ldp);
      wmma::load_matrix_sync(fb, Vs + kb * 16 * LDK + db * 16, LDK);
      wmma::mma_sync(o, fa, fb, o);
    }
    wmma::store_matrix_sync(Sw + db * 16, o, LDO, wmma::mem_row_major);
  }
  __syncwarp();

  // heads interleaved: out[b, t, h*hd + d]
  for (int e = lane; e < 16 * HD; e += 32) {
    const int r = e / HD, d = e % HD;
    const int t = q0 + warp * 16 + r;
    if (t < n_pad)
      out[((size_t)b * n_pad + t) * (H * HD) + h * HD + d] =
          __float2bfloat16(Sw[r * LDO + d]);
  }
}

}  // namespace vit
