// Fused transformer MLP for Hopper (sm_90a): optional LayerNorm -> fc1 ->
// exact-erf GELU -> fc2 -> optional residual, one launch, the [rows, H]
// hidden never written to device memory.
//
// Replaces the TPU kernel hipt_abmil_atec23_tpu/ops/fused_mlp.py _kernel
// (launcher _run). That kernel keeps both weight matrices resident in VMEM
// (2.4 MB at D=384, H=1536) and streams 512-row tiles. One SM here has at
// most 227 KB of shared memory, and a 64-row tile of the bf16 hidden alone
// is 196 KB at H=1536, so each CTA takes 64 rows and walks H in chunks of
// 64 hidden units:
//
//   xs  = bf16(LN(x) or x)                    [64, D] in shared memory
//   for each chunk c of 64 hidden units:
//     W1[:, c], W2[c, :] staged into shared memory
//     h_c = bf16(GELU_erf(xs . W1[:, c] + b1[c]))      [64, 64]
//     acc += h_c . W2[c, :]                   f32 WMMA fragments, registers
//   out = x.dtype((acc + b2) + x)              residual on the loaded x
//
// LN statistics, bias adds, GELU and the residual run in f32. The two
// products are WMMA bf16 16x16x16 with f32 accumulation: their operands
// (the normalised rows, the post-GELU hidden) round to bf16, as the TPU's
// MXU rounds f32 operands at default precision. GELU uses erff (the TPU
// kernel uses the Abramowitz-Stegun 7.1.26 erf only because Mosaic lacks
// erf; the two differ by at most 1.5e-7).
//
// Bound on this card: 4 * rows * D * H operations against 2 * rows * D
// bytes of rows, so the tensor cores bound it (310 GFLOP at the slice's
// [131584, 384], H=1536). This first version stages the weight chunks
// synchronously (no cp.async/TMA, no wgmma) and re-reads them from L2 for
// every 64-row tile, so it runs well below the bf16 peak.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int MT = 64;        // rows per CTA
constexpr int HC = 64;        // hidden units per chunk
constexpr int THREADS = 256;  // 8 warps: 4 row bands x 2 column halves
constexpr int WARPS = THREADS / 32;

__host__ __device__ inline size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

struct Layout {
  size_t xs, w1, w2, hs, hb, os, total;
};

// xs [MT][D+8] bf16, w1 chunk [D][HC+8] bf16, w2 chunk [HC][D+8] bf16,
// hidden f32 [MT][HC+4] and bf16 [MT][HC+8]; the f32 output tile
// [MT][D+4] reuses the two weight chunks after the last one
__host__ __device__ inline Layout layout(int D) {
  Layout L;
  L.xs = 0;
  L.w1 = L.xs + align128((size_t)MT * (D + 8) * sizeof(bf16));
  L.w2 = L.w1 + align128((size_t)D * (HC + 8) * sizeof(bf16));
  L.hs = L.w2 + align128((size_t)HC * (D + 8) * sizeof(bf16));
  L.hb = L.hs + align128((size_t)MT * (HC + 4) * sizeof(float));
  L.total = L.hb + align128((size_t)MT * (HC + 8) * sizeof(bf16));
  L.os = L.w1;  // MT*(D+4)*4 <= the two chunks' bytes for every D
  return L;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// NF = D / 32: each warp owns 16 rows x D/2 columns of the output, NF
// fragments of 16 x 16
template <int NF>
__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 const float* __restrict__ b2, bf16* __restrict__ out, int R,
                 int H, int with_ln, int residual, float eps) {
  constexpr int D = NF * 32;
  constexpr int PER_LANE = D / 32;
  constexpr int LDX = D + 8, LDW1 = HC + 8, LDW2 = D + 8;
  constexpr int LDH = HC + 4, LDHB = HC + 8, LDO = D + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(D);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
  bf16* w1s = reinterpret_cast<bf16*>(smem + L.w1);
  bf16* w2s = reinterpret_cast<bf16*>(smem + L.w2);
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  bf16* hb = reinterpret_cast<bf16*>(smem + L.hb);
  float* os = reinterpret_cast<float*>(smem + L.os);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * MT;

  // rows -> f32 -> LayerNorm (one warp per row) -> bf16 operand tile;
  // rows past R are zeros and are never stored
  for (int r = warp; r < MT; r += WARPS) {
    float v[PER_LANE];
    const bool live = r0 + r < R;
    const bf16* xr = x + (size_t)(r0 + r) * D;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      v[i] = live ? __bfloat162float(xr[lane + 32 * i]) : 0.f;
    if (with_ln) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) s += v[i];
      const float mu = warp_sum(s) / D;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) q += (v[i] - mu) * (v[i] - mu);
      const float rstd = rsqrtf(warp_sum(q) / D + eps);
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int c = lane + 32 * i;
        v[i] = (v[i] - mu) * rstd * gamma[c] + beta[c];
      }
    }
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      xs[r * LDX + lane + 32 * i] = __float2bfloat16(v[i]);
  }

  const int wr = (warp >> 1) * 16;   // this warp's 16 rows
  const int wc = warp & 1;           // and column half
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int c0 = 0; c0 < H; c0 += HC) {
    // W1[:, c0:c0+64] (8 16-byte vectors per row) and W2[c0:c0+64, :]
    for (int e = tid; e < D * (HC / 8); e += THREADS) {
      const int k = e / (HC / 8), c = (e % (HC / 8)) * 8;
      *reinterpret_cast<uint4*>(w1s + k * LDW1 + c) =
          *reinterpret_cast<const uint4*>(w1 + (size_t)k * H + c0 + c);
    }
    for (int e = tid; e < HC * (D / 8); e += THREADS) {
      const int k = e / (D / 8), c = (e % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(w2s + k * LDW2 + c) =
          *reinterpret_cast<const uint4*>(w2 + (size_t)(c0 + k) * D + c);
    }
    __syncthreads();

    // hidden chunk: each warp 16 rows x 32 of the 64 units
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> h;
      wmma::fill_fragment(h, 0.f);
#pragma unroll 4
      for (int k = 0; k < D; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, xs + wr * LDX + k, LDX);
        wmma::load_matrix_sync(fb, w1s + k * LDW1 + wc * 32 + j * 16, LDW1);
        wmma::mma_sync(h, fa, fb, h);
      }
      wmma::store_matrix_sync(hs + wr * LDH + wc * 32 + j * 16, h, LDH,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = tid; e < MT * HC; e += THREADS) {
      const int r = e / HC, c = e % HC;
      const float v = hs[r * LDH + c] + b1[c0 + c];
      hb[r * LDHB + c] =
          __float2bfloat16(v * 0.5f * (1.f + erff(v * 0.70710678118654752f)));
    }
    __syncthreads();

    // acc += h_c . W2[c0:c0+64, this warp's columns]
#pragma unroll
    for (int k = 0; k < HC; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, hb + wr * LDHB + k, LDHB);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, w2s + k * LDW2 + wc * (D / 2) + j * 16,
                               LDW2);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();  // before the next chunk overwrites the tiles
  }

#pragma unroll
  for (int j = 0; j < NF; ++j)
    wmma::store_matrix_sync(os + wr * LDO + wc * (D / 2) + j * 16, acc[j],
                            LDO, wmma::mem_row_major);
  __syncthreads();
  for (int r = warp; r < MT; r += WARPS) {
    if (r0 + r >= R) break;
    const size_t row = (size_t)(r0 + r) * D;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int c = lane + 32 * i;
      float o = os[r * LDO + c] + b2[c];
      if (residual) o += __bfloat162float(x[row + c]);
      out[row + c] = __float2bfloat16(o);
    }
  }
}

template <int NF>
cudaError_t launch(const bf16* x, const float* g, const float* be,
                   const bf16* w1, const float* b1, const bf16* w2,
                   const float* b2, bf16* out, int R, int H, int with_ln,
                   int residual, float eps, cudaStream_t s) {
  const size_t smem = layout(NF * 32).total;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_mlp_kernel<NF><<<(R + MT - 1) / MT, THREADS, smem, s>>>(
      x, g, be, w1, b1, w2, b2, out, R, H, with_ln, residual, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fused_mlp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x, out [R, D] bf16; gamma, beta [D] f32 (null without LN); w1 [D, H] and
// w2 [H, D] bf16 row-major (the JAX layout); b1 [H], b2 [D] f32. D a
// multiple of 32 up to 384, H a multiple of 64. Returns the CUDA error.
int fused_mlp_forward(const bf16* x, const float* gamma, const float* beta,
                      const bf16* w1, const float* b1, const bf16* w2,
                      const float* b2, bf16* out, int R, int D, int H,
                      int with_ln, int residual, float eps, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (R == 0) return 0;
  if (D % 32 || D > 384 || H % HC || (with_ln && (!gamma || !beta)))
    return (int)cudaErrorInvalidValue;
#define HK_CASE(nf)                                                         \
  case nf:                                                                  \
    return (int)launch<nf>(x, gamma, beta, w1, b1, w2, b2, out, R, H,       \
                           with_ln, residual, eps, s);
  switch (D / 32) {
    HK_CASE(1) HK_CASE(2) HK_CASE(3) HK_CASE(4) HK_CASE(5) HK_CASE(6)
    HK_CASE(7) HK_CASE(8) HK_CASE(9) HK_CASE(10) HK_CASE(11) HK_CASE(12)
  }
#undef HK_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
