// One pre-norm ViT block (LN1 -> QKV -> attention -> proj + residual ->
// LN2 -> fc1 -> GELU -> fc2 + residual) for Hopper (sm_90a).
//
// Replaces the TPU kernel hipt_abmil_atec23_tpu/ops/fused_block.py
// _block_kernel. That kernel keeps a whole image group in a 100 MB VMEM
// budget; one SM here has at most 227 KB of shared memory, so the block runs
// as seven launches whose intermediates keep the TPU kernel's rounding
// points (device code in vit_block.cuh):
//
//   layernorm   x (bf16 or f32)   -> xn  = bf16(LN1(x))
//   gemm<QKV>   xn . Wqkv^T + b   -> q = bf16(q_f32 * hd^-1/2), k, v bf16,
//                                    head-major [3, B, H, n_pad, hd]
//   attention   per (image, head): K and V in shared memory once, f32
//               scores, keys >= n_valid at -1e30, f32 softmax,
//               P = bf16(e / sum e), O = P . V in f32 -> bf16 [B, n_pad, D]
//   gemm<PROJ>  x2 = (x + O . Wproj^T) + bproj, kept in f32 (never rounded)
//   layernorm   xn2 = bf16(LN2(x2))
//   gemm<FC1>   h = bf16(GELU_erf(xn2 . W1^T + b1))
//   gemm<FC2>   out = (x2 + h . W2^T) + b2, stored in x's dtype
//
// The residual stream x is bf16 or f32, as the TPU kernel's: it reads x as
// f32 and rounds only the GEMM operands to bf16, so an f32 x gives an f32
// block with bf16 operands.
//
// Concatenating the heads before one proj GEMM equals the TPU kernel's
// per-head sum of o_h . Wproj[h]; only the summation order differs. GELU
// uses the exact erff (the TPU kernel uses Abramowitz-Stegun 7.1.26 only
// because Mosaic lacks erf).
//
// Bound on this card: the four GEMMs are ~90% of the block's FLOPs and are
// tensor-core bound, so they run on wgmma fed by a TMA copy ring (one
// producer warp, two consumer warpgroups, 3 stages of 128 x 64 tiles, ~97
// KB: two CTAs per SM, so one CTA's epilogue overlaps the other's
// products). Attention loads each head's K and V once (n_pad x hd bf16,
// ~92 KB with padding at 264 tokens and hd 64: two CTAs per SM) and keeps
// its scores in mma.sync registers.
#include "vit_block.cuh"

using namespace vit;

namespace {

constexpr int LN_WARPS = 8;

// two rows per warp: rows r and r + LN_WARPS of the CTA's 2 LN_WARPS
template <typename TIn>
__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_kernel(const TIn* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, bf16* __restrict__ y, int M,
                 int D, float eps) {
  const int row = blockIdx.x * 2 * LN_WARPS + (threadIdx.x >> 5);
  layernorm_rows2<TIn>(x, g, b, y, D, eps, row, row + LN_WARPS, M, nullptr);
}

// one CTA per 128 x 128 tile
template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_kernel(const __grid_constant__ CUtensorMap amap,
            const __grid_constant__ CUtensorMap wmap, int M, int N, int K,
            EpiArgs ep) {
  __shared__ __align__(8) uint64_t bars[2 * GEMM_STAGES];
  __shared__ int slots[GEMM_STAGES];
  extern __shared__ __align__(128) unsigned char smem[];
  Ring ring = ring_init(bars, slots);
  gemm_tiles<EPI>(&amap, &wmap, 0, M, N, K, ep, align1024(smem), ring,
                  Sched{(int)blockIdx.x, (int)gridDim.x, nullptr});
}

template <int HD>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                 int B, int H, int n_pad, int n_valid) {
  extern __shared__ __align__(128) unsigned char smem[];
  attention_head<HD>(qkv, out, B, H, n_pad, n_valid, blockIdx.x, blockIdx.y,
                     smem);
}

// C = A[M, K] . W[N, K]^T, one CTA per 128 x 128 tile
template <int EPI>
cudaError_t launch_gemm(const bf16* A, const bf16* W, int M, int N, int K,
                        const EpiArgs& ep, cudaStream_t s) {
  CUtensorMap amap, wmap;
  if (!tile_map(&amap, A, K, M, 1) || !tile_map(&wmap, W, K, N, 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)GEMM_SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = (M + BM - 1) / BM * ((N + BN - 1) / BN);
  gemm_kernel<EPI><<<tiles, GEMM_THREADS, GEMM_SMEM, s>>>(amap, wmap, M, N,
                                                          K, ep);
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t launch_layernorm(const TIn* x, const float* g, const float* b,
                             bf16* y, int M, int D, float eps,
                             cudaStream_t s) {
  const int rows = 2 * LN_WARPS;
  layernorm_kernel<TIn><<<(M + rows - 1) / rows, LN_WARPS * 32, 0, s>>>(
      x, g, b, y, M, D, eps);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_attention(const bf16* qkv, bf16* out, int B, int H,
                             int n_pad, int n_valid, cudaStream_t s) {
  const size_t smem = att_smem(n_pad, HD);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  attention_kernel<HD><<<dim3(H, B), GEMM_THREADS, smem, s>>>(
      qkv, out, B, H, n_pad, n_valid);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// shared memory the attention launch needs at this token count, so the
// caller can refuse shapes past the card's 227 KB per block
size_t fused_block_attention_smem(int n_pad, int hd) {
  return att_smem(n_pad, hd);
}

const char* fused_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x, out [B, n_pad, D], both bf16 (x_f32 = 0) or both f32 (x_f32 = 1);
// Linear weights bf16 in torch [out, in] layout; LayerNorm parameters and
// biases f32. Scratch (caller-allocated): xn [M, D] bf16,
// qkv [3, B, H, n_pad, hd] bf16, attn [M, D] bf16, x2 [M, D] f32,
// hidden [M, F] bf16; scale = hd^-1/2. Returns the first CUDA error
// (cudaErrorInvalidValue also when the driver refuses a TMA map).
int fused_block_forward(const void* x, const float* ln1_g, const float* ln1_b,
                        const bf16* wqkv, const float* bqkv, const bf16* wproj,
                        const float* bproj, const float* ln2_g,
                        const float* ln2_b, const bf16* w1, const float* b1,
                        const bf16* w2, const float* b2, bf16* xn, bf16* qkv,
                        bf16* attn, float* x2, bf16* hidden, void* out, int B,
                        int n_pad, int D, int heads, int n_valid, int F,
                        int x_f32, float eps, float scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * n_pad, hd = D / heads;
  cudaError_t err;
#define HK_CHECK(call)                       \
  do {                                       \
    err = (call);                            \
    if (err != cudaSuccess) return (int)err; \
  } while (0)

  if (hd != 64 && hd != 32) return (int)cudaErrorInvalidValue;
  if (x_f32)
    HK_CHECK(launch_layernorm<float>(static_cast<const float*>(x), ln1_g,
                                     ln1_b, xn, M, D, eps, s));
  else
    HK_CHECK(launch_layernorm<bf16>(static_cast<const bf16*>(x), ln1_g,
                                    ln1_b, xn, M, D, eps, s));
  EpiArgs ep = {};
  ep.bias = bqkv;
  ep.qkv = qkv;
  ep.batch = B;
  ep.n_pad = n_pad;
  ep.heads = heads;
  ep.hd = hd;
  ep.dim = D;
  ep.scale = scale;
  HK_CHECK(launch_gemm<EPI_QKV>(xn, wqkv, M, 3 * D, D, ep, s));
  if (hd == 64)
    HK_CHECK(launch_attention<64>(qkv, attn, B, heads, n_pad, n_valid, s));
  else
    HK_CHECK(launch_attention<32>(qkv, attn, B, heads, n_pad, n_valid, s));
  ep = EpiArgs{};
  ep.bias = bproj;
  if (x_f32)
    ep.res_f32 = static_cast<const float*>(x);
  else
    ep.res_bf16 = static_cast<const bf16*>(x);
  ep.out_f32 = x2;
  HK_CHECK(launch_gemm<EPI_PROJ>(attn, wproj, M, D, D, ep, s));
  HK_CHECK(launch_layernorm<float>(x2, ln2_g, ln2_b, xn, M, D, eps, s));
  ep = EpiArgs{};
  ep.bias = b1;
  ep.out_bf16 = hidden;
  HK_CHECK(launch_gemm<EPI_FC1>(xn, w1, M, F, D, ep, s));
  ep = EpiArgs{};
  ep.bias = b2;
  ep.res_f32 = x2;
  if (x_f32)
    ep.out_f32 = static_cast<float*>(out);
  else
    ep.out_bf16 = static_cast<bf16*>(out);
  HK_CHECK(launch_gemm<EPI_FC2>(hidden, w2, M, D, F, ep, s));
#undef HK_CHECK
  return 0;
}

}  // extern "C"
