// Attention softmax(q k^T d^-1/2) v over [BH, N, d] bf16 for Hopper (sm_90a),
// keys at or past n_valid masked to -1e30. Two kernels:
//
// fused_attention_kernel replaces the TPU kernel
//   hipt_abmil_atec23_tpu/ops/flash_attention.py _fused_attn_kernel
//   (launcher fused_attention). That kernel keeps a head group's whole K and
//   V resident in up to 64 MiB of VMEM and takes full-row softmax
//   statistics before one normalised, bf16-rounded P . V. An SM has 227 KB,
//   which whole-resident K and V outgrow past ~800 tokens at d=64, so this
//   kernel keeps the TPU kernel's rounding points but streams 64-key tiles
//   twice: pass 1 takes each query row's max and sum of exp (f32, online),
//   pass 2 recomputes the scores, forms p = exp(s - m) / l, rounds p to
//   bf16 and accumulates P . V in f32. Scores are f32 products of the bf16
//   operands, scaled after the product. One CTA per (head, 64-query tile),
//   four warps of 16 query rows. At the ViT's N=257 a head's K and V
//   (66 KB) stay in L2 between the two passes. The TPU wrapper's query-tiled
//   branch (N > 1024, K/V resident in VMEM) launches this same kernel:
//   ``group`` and ``block_q`` only shape the TPU grid.
//
// flash_attention_kernel replaces the TPU kernel
//   hipt_abmil_atec23_tpu/ops/flash_attention.py _flash_kernel (launcher
//   flash_attention): one pass over 64-key tiles with the online-softmax
//   recurrence in f32 (m, l, and the accumulator rescaled by
//   alpha = exp(m_prev - m_new)), p not normalised before P . V, and the
//   division by max(l, 1e-30) at the end. The TPU kernel multiplies in f32
//   on the MXU, which rounds f32 operands to bf16 at default precision; here
//   P rounds to bf16 for the WMMA product (l sums the f32 p).
//
// Bound on this card: at the ViT's N=257, d=64 the kernel moves 4 * BH * N
// * d bf16 (q, k, v in, o out) for 4 * BH * N^2 * d operations, about 130
// operations per byte, below the card's ~295: bytes bound it. At long N
// (the flash branch) operations bound it. This first version stages tiles
// synchronously through shared memory (WMMA, no cp.async/TMA, no wgmma).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float kNegInf = -1e30f;
constexpr int WARPS = 4;
constexpr int QT = 16 * WARPS;  // query rows per CTA
constexpr int KT = 64;          // keys per tile
constexpr int LDS = KT + 4;     // f32 score tile row stride
constexpr int LDP = KT + 8;     // bf16 probability tile row stride

__host__ __device__ inline size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

struct Layout {
  size_t q, k, v, s, p, o, stat, total;
};

// Q, K, V tiles [64][hd+8] bf16; per warp: scores [16][KT+4] f32 (reused
// for a [16][hd+4] f32 product), probabilities [16][KT+8] bf16, the flash
// accumulator [16][hd+4] f32, and two f32 per row (alpha, l)
__host__ __device__ inline Layout layout(int hd) {
  Layout L;
  const size_t tile = align128((size_t)64 * (hd + 8) * sizeof(bf16));
  L.q = 0;
  L.k = tile;
  L.v = 2 * tile;
  L.s = 3 * tile;
  L.p = L.s + WARPS * align128((size_t)16 * LDS * sizeof(float));
  L.o = L.p + WARPS * align128((size_t)16 * LDP * sizeof(bf16));
  L.stat = L.o + WARPS * align128((size_t)16 * (hd + 4) * sizeof(float));
  L.total = L.stat + WARPS * align128(2 * 16 * sizeof(float));
  return L;
}

// rows [row0, row0 + 64) of one head into a [64][HD+8] tile; rows past N
// are zeros
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int N) {
  constexpr int VPR = HD / 8;  // 16-byte vectors per row
  for (int e = threadIdx.x; e < 64 * VPR; e += WARPS * 32) {
    const int r = e / VPR, c = (e % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < N)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + c) = val;
  }
}

// S_w [16][KT] = Q_w [16][HD] . K_tile^T, f32
template <int HD>
__device__ __forceinline__ void tile_scores(const bf16* Qw, const bf16* Ks,
                                            float* Sw) {
#pragma unroll
  for (int kb = 0; kb < KT / 16; ++kb) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
    wmma::fill_fragment(s, 0.f);
#pragma unroll
    for (int kd = 0; kd < HD; kd += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, Qw + kd, HD + 8);
      wmma::load_matrix_sync(fb, Ks + kb * 16 * (HD + 8) + kd, HD + 8);
      wmma::mma_sync(s, fa, fb, s);
    }
    wmma::store_matrix_sync(Sw + kb * 16, s, LDS, wmma::mem_row_major);
  }
}

// O_frag[HD/16] (+)= P_w [16][KT] . V_tile [KT][HD]
template <int HD>
__device__ __forceinline__ void tile_pv(
    const bf16* Pw, const bf16* Vs,
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* o) {
#pragma unroll
  for (int kb = 0; kb < KT / 16; ++kb) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, Pw + kb * 16, LDP);
#pragma unroll
    for (int db = 0; db < HD / 16; ++db) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, Vs + kb * 16 * (HD + 8) + db * 16, HD + 8);
      wmma::mma_sync(o[db], fa, fb, o[db]);
    }
  }
}

// Each query row of a warp's 16 is held by lanes r and r + 16, each
// over 32 of the tile's 64 columns; this lane's scaled, masked scores.
__device__ __forceinline__ void row_scores(const float* Sw, int k0,
                                           int n_valid, float scale,
                                           float* s) {
  const int lane = threadIdx.x & 31, r = lane & 15, half = lane >> 4;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int col = half * 32 + c;
    s[c] = k0 + col < n_valid ? Sw[r * LDS + col] * scale : kNegInf;
  }
}

__device__ __forceinline__ float pair_max(float v) {
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

__device__ __forceinline__ float pair_sum(float v) {
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
fused_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int N, int n_valid, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(HD);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Sw = reinterpret_cast<float*>(
      smem + L.s + warp * align128((size_t)16 * LDS * sizeof(float)));
  bf16* Pw = reinterpret_cast<bf16*>(
      smem + L.p + warp * align128((size_t)16 * LDP * sizeof(bf16)));

  const size_t head = (size_t)blockIdx.x * N * HD;
  const int q0 = blockIdx.y * QT;
  const int r = lane & 15, half = lane >> 4;
  load_tile<HD>(Qs, q + head, q0, N);
  const bf16* Qw = Qs + warp * 16 * (HD + 8);
  const int n_tiles = (n_valid + KT - 1) / KT;  // later tiles add exp(-1e30-m)=0

  // pass 1: each row's max and sum of exp(s - max), online
  float m = kNegInf, l = 0.f, s[32];
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_tile<HD>(Ks, k + head, t * KT, N);
    __syncthreads();
    tile_scores<HD>(Qw, Ks, Sw);
    __syncwarp();
    row_scores(Sw, t * KT, n_valid, scale, s);
    float mt = kNegInf;
#pragma unroll
    for (int c = 0; c < 32; ++c) mt = fmaxf(mt, s[c]);
    const float m_new = fmaxf(m, pair_max(mt));
    float e = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) e += expf(s[c] - m_new);
    l = l * expf(m - m_new) + pair_sum(e);
    m = m_new;
    __syncwarp();
  }

  // pass 2: p = bf16(exp(s - m) / l), O += P . V in f32
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HD / 16];
#pragma unroll
  for (int db = 0; db < HD / 16; ++db) wmma::fill_fragment(o[db], 0.f);
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_tile<HD>(Ks, k + head, t * KT, N);
    load_tile<HD>(Vs, v + head, t * KT, N);
    __syncthreads();
    tile_scores<HD>(Qw, Ks, Sw);
    __syncwarp();
    row_scores(Sw, t * KT, n_valid, scale, s);
#pragma unroll
    for (int c = 0; c < 32; ++c)
      Pw[r * LDP + half * 32 + c] = __float2bfloat16(expf(s[c] - m) / l);
    __syncwarp();
    tile_pv<HD>(Pw, Vs, o);
  }

  // O through the (free) score tile, rows past N dropped
#pragma unroll
  for (int db = 0; db < HD / 16; ++db)
    wmma::store_matrix_sync(Sw + db * 16, o[db], HD + 4, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * HD; e += 32) {
    const int row = e / HD, d = e % HD;
    const int tok = q0 + warp * 16 + row;
    if (tok < N)
      out[head + (size_t)tok * HD + d] = __float2bfloat16(Sw[row * (HD + 4) + d]);
  }
}

template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int N, int n_valid, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDO = HD + 4;
  const Layout L = layout(HD);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Sw = reinterpret_cast<float*>(
      smem + L.s + warp * align128((size_t)16 * LDS * sizeof(float)));
  bf16* Pw = reinterpret_cast<bf16*>(
      smem + L.p + warp * align128((size_t)16 * LDP * sizeof(bf16)));
  float* Ow = reinterpret_cast<float*>(
      smem + L.o + warp * align128((size_t)16 * LDO * sizeof(float)));
  float* stat = reinterpret_cast<float*>(
      smem + L.stat + warp * align128(2 * 16 * sizeof(float)));

  const size_t head = (size_t)blockIdx.x * N * HD;
  const int q0 = blockIdx.y * QT;
  const int r = lane & 15, half = lane >> 4;
  load_tile<HD>(Qs, q + head, q0, N);
  const bf16* Qw = Qs + warp * 16 * (HD + 8);
  for (int e = lane; e < 16 * LDO; e += 32) Ow[e] = 0.f;
  const int n_tiles = (n_valid + KT - 1) / KT;

  float m = kNegInf, l = 0.f, s[32];
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_tile<HD>(Ks, k + head, t * KT, N);
    load_tile<HD>(Vs, v + head, t * KT, N);
    __syncthreads();
    tile_scores<HD>(Qw, Ks, Sw);
    __syncwarp();
    row_scores(Sw, t * KT, n_valid, scale, s);
    float mt = kNegInf;
#pragma unroll
    for (int c = 0; c < 32; ++c) mt = fmaxf(mt, s[c]);
    const float m_new = fmaxf(m, pair_max(mt));
    const float alpha = expf(m - m_new);
    float e = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = expf(s[c] - m_new);
      e += p;
      Pw[r * LDP + half * 32 + c] = __float2bfloat16(p);
    }
    l = l * alpha + pair_sum(e);
    m = m_new;
    if (half == 0) stat[r] = alpha;
    __syncwarp();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> pv[HD / 16];
#pragma unroll
    for (int db = 0; db < HD / 16; ++db) wmma::fill_fragment(pv[db], 0.f);
    tile_pv<HD>(Pw, Vs, pv);
#pragma unroll
    for (int db = 0; db < HD / 16; ++db)
      wmma::store_matrix_sync(Sw + db * 16, pv[db], LDO, wmma::mem_row_major);
    __syncwarp();
    for (int e2 = lane; e2 < 16 * HD; e2 += 32) {
      const int row = e2 / HD, d = e2 % HD;
      Ow[row * LDO + d] = Ow[row * LDO + d] * stat[row] + Sw[row * LDO + d];
    }
    __syncwarp();
  }

  if (half == 0) stat[16 + r] = fmaxf(l, 1e-30f);
  __syncwarp();
  for (int e = lane; e < 16 * HD; e += 32) {
    const int row = e / HD, d = e % HD;
    const int tok = q0 + warp * 16 + row;
    if (tok < N)
      out[head + (size_t)tok * HD + d] =
          __float2bfloat16(Ow[row * LDO + d] / stat[16 + row]);
  }
}

template <int HD>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                   int BH, int N, int n_valid, float scale, int flash,
                   cudaStream_t s) {
  const size_t smem = layout(HD).total;
  void (*kern)(const bf16*, const bf16*, const bf16*, bf16*, int, int,
               float) = flash ? &flash_attention_kernel<HD>
                              : &fused_attention_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (N + QT - 1) / QT);
  kern<<<grid, WARPS * 32, smem, s>>>(q, k, v, out, N, n_valid, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, k, v, out [BH, N, hd] bf16 contiguous; hd 32 or 64; 0 < n_valid <= N;
// flash = 0 runs the two-pass kernel (B.6), 1 the online-softmax kernel
// (B.7). Returns the CUDA error.
int attention_forward(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                      int BH, int N, int hd, int n_valid, float scale,
                      int flash, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (BH == 0 || N == 0) return 0;
  if (n_valid <= 0 || n_valid > N || (N + QT - 1) / QT > 65535)
    return (int)cudaErrorInvalidValue;
  if (hd == 64) return (int)launch<64>(q, k, v, out, BH, N, n_valid, scale,
                                       flash, s);
  if (hd == 32) return (int)launch<32>(q, k, v, out, BH, N, n_valid, scale,
                                       flash, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
