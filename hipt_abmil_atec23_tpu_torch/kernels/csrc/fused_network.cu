// Every block of a pre-norm ViT stack in ONE launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel hipt_abmil_atec23_tpu/ops/fused_network.py
// _network_kernel (launcher fused_vit_network). That kernel holds an image
// group's tokens and the whole stack's stacked weights in VMEM and loops the
// blocks inside one kernel, so the residual stream stays f32 from the first
// block to the last and rounds once, to x's dtype, at the end.
//
// An SM here has 227 KB of shared memory, and one image's f32 residual at
// ViT-256 width (264 x 384) is 405 KB, so the stack cannot live in one CTA.
// This kernel is a persistent cooperative grid instead: as many 256-thread
// CTAs as are co-resident (one per SM at 264 tokens: attention takes ~190 KB
// of shared memory), launched with cudaLaunchCooperativeKernel. It loops
// over the T blocks itself, and per block walks B.1's seven stages
// (vit_block.cuh) as grid-stride loops over their tiles, with a grid-wide
// barrier (cooperative_groups::this_grid().sync()) between stages:
//
//   LN1    xn = bf16(LN1(xres))            one warp per row; block 0 reads x
//                                          and stores it to xres as f32
//   QKV    qkv = head-major bf16, q scaled in f32 before its cast
//   ATTN   per (image, head, 64-query tile); warps 0-3 compute, 4-7 help
//          load K, V and Q (eight [16, nk] f32 score tiles would not fit)
//   PROJ   x2 = (xres + O . Wproj^T) + bproj          f32
//   LN2    xn = bf16(LN2(x2))
//   FC1    h = bf16(GELU_erf(xn . W1^T + b1))
//   FC2    xres = (x2 + h . W2^T) + b2                f32; the last block
//                                                     stores out in x's dtype
//
// The f32 residual and the stage intermediates live in caller-allocated
// device memory. Bound on this card: the GEMMs are tensor-core work (6.2
// TFLOP for ViT-256's 12 blocks on 512 images), against 0.25 GB that must
// move, so operations bound it; this first version runs B.1's synchronous
// WMMA tiles with one CTA per SM and pays 7 grid barriers per block.
#include <cooperative_groups.h>

#include "vit_block.cuh"

namespace cg = cooperative_groups;
using namespace vit;

namespace {

struct NetArgs {
  const void* x;                      // [B, n_pad, D] bf16 or f32
  const float *ln1_g, *ln1_b;         // [T, D]
  const bf16* wqkv;                   // [T, 3D, D]
  const float* bqkv;                  // [T, 3D]
  const bf16* wproj;                  // [T, D, D]
  const float* bproj;                 // [T, D]
  const float *ln2_g, *ln2_b;         // [T, D]
  const bf16* w1;                     // [T, F, D]
  const float* b1;                    // [T, F]
  const bf16* w2;                     // [T, D, F]
  const float* b2;                    // [T, D]
  float* xres;                        // [M, D] f32 residual
  bf16* xn;                           // [M, D]
  bf16* qkv;                          // [3, B, H, n_pad, hd]
  bf16* attn;                         // [M, D]
  float* x2;                          // [M, D]
  bf16* hidden;                       // [M, F]
  void* out;                          // [B, n_pad, D], x's dtype
  int T, B, n_pad, D, heads, n_valid, F;
  float eps, scale;
};

template <int EPI>
__device__ __forceinline__ void gemm_stage(const bf16* A, const bf16* W,
                                           int M, int N, int K,
                                           const EpiArgs& ep,
                                           unsigned char* smem) {
  const int tn = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tn;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    __syncthreads();  // the previous tile's epilogue is done with smem
    gemm_tile<EPI>(A, W, M, N, K, ep, (tile / tn) * BM, (tile % tn) * BN,
                   smem);
  }
}

template <typename TX, int HD>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
network_kernel(NetArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int D = a.D, F = a.F, M = a.B * a.n_pad;
  const int nk = att_nk(a.n_pad);
  const int warps = GEMM_THREADS / 32;
  const int gwarp = blockIdx.x * warps + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * warps;
  const int qtiles = (a.n_pad + ATT_QT - 1) / ATT_QT;
  const int att_units = a.B * a.heads * qtiles;

  for (int t = 0; t < a.T; ++t) {
    const size_t tv = (size_t)t * D;
    // LN1
    for (int row = gwarp; row < M; row += nwarps) {
      const size_t off = (size_t)row * D;
      if (t == 0)
        layernorm_row<TX>(static_cast<const TX*>(a.x) + off, a.ln1_g + tv,
                          a.ln1_b + tv, a.xn + off, D, a.eps, a.xres + off);
      else
        layernorm_row<float>(a.xres + off, a.ln1_g + tv, a.ln1_b + tv,
                             a.xn + off, D, a.eps, nullptr);
    }
    grid.sync();

    EpiArgs ep = {};
    ep.bias = a.bqkv + (size_t)t * 3 * D;
    ep.qkv = a.qkv;
    ep.batch = a.B;
    ep.n_pad = a.n_pad;
    ep.heads = a.heads;
    ep.hd = HD;
    ep.dim = D;
    ep.scale = a.scale;
    gemm_stage<EPI_QKV>(a.xn, a.wqkv + (size_t)t * 3 * D * D, M, 3 * D, D,
                        ep, smem);
    grid.sync();

    for (int u = blockIdx.x; u < att_units; u += gridDim.x) {
      __syncthreads();  // the previous unit is done with K, V and Q
      const int qt = u % qtiles, bh = u / qtiles;
      attention_tile<HD>(a.qkv, a.attn, a.B, a.heads, a.n_pad, a.n_valid, nk,
                         qt * ATT_QT, bh % a.heads, bh / a.heads, smem);
    }
    grid.sync();

    ep = EpiArgs{};
    ep.bias = a.bproj + tv;
    ep.res_f32 = a.xres;
    ep.out_f32 = a.x2;
    gemm_stage<EPI_PROJ>(a.attn, a.wproj + (size_t)t * D * D, M, D, D, ep,
                         smem);
    grid.sync();

    for (int row = gwarp; row < M; row += nwarps) {
      const size_t off = (size_t)row * D;
      layernorm_row<float>(a.x2 + off, a.ln2_g + tv, a.ln2_b + tv,
                           a.xn + off, D, a.eps, nullptr);
    }
    grid.sync();

    ep = EpiArgs{};
    ep.bias = a.b1 + (size_t)t * F;
    ep.out_bf16 = a.hidden;
    gemm_stage<EPI_FC1>(a.xn, a.w1 + (size_t)t * F * D, M, F, D, ep, smem);
    grid.sync();

    ep = EpiArgs{};
    ep.bias = a.b2 + tv;
    ep.res_f32 = a.x2;
    if (t + 1 < a.T)
      ep.out_f32 = a.xres;
    else if (sizeof(TX) == sizeof(float))
      ep.out_f32 = static_cast<float*>(a.out);
    else
      ep.out_bf16 = static_cast<bf16*>(a.out);
    gemm_stage<EPI_FC2>(a.hidden, a.w2 + (size_t)t * D * F, M, D, F, ep,
                        smem);
    grid.sync();
  }
}

typedef void (*NetKernel)(NetArgs);

NetKernel pick(int x_f32, int hd) {
  if (hd == 64)
    return x_f32 ? &network_kernel<float, 64> : &network_kernel<bf16, 64>;
  if (hd == 32)
    return x_f32 ? &network_kernel<float, 32> : &network_kernel<bf16, 32>;
  return nullptr;
}

size_t smem_bytes(int n_pad, int hd) {
  const size_t att = att_layout(att_nk(n_pad), hd).total;
  return att > GEMM_SMEM ? att : GEMM_SMEM;
}

}  // namespace

extern "C" {

// dynamic shared memory per CTA at this token count and head size, so the
// caller can refuse shapes past the card's 227 KB per block
size_t fused_network_smem(int n_pad, int hd) { return smem_bytes(n_pad, hd); }

const char* fused_network_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x, out [B, n_pad, D], both bf16 (x_f32 = 0) or both f32 (x_f32 = 1);
// stacked Linear weights bf16 in torch [out, in] layout per block
// ([T, 3D, D], [T, D, D], [T, F, D], [T, D, F]); LayerNorm parameters and
// biases f32 [T, *]. Scratch (caller-allocated): xres [M, D] f32, xn [M, D]
// bf16, qkv [3, B, H, n_pad, hd] bf16, attn [M, D] bf16, x2 [M, D] f32,
// hidden [M, F] bf16; scale = hd^-1/2. ``grid`` CTAs, or with grid <= 0 all
// that are co-resident; a grid past that fails the cooperative launch.
// Returns the first CUDA error; the kernel never runs on an error.
int fused_network_forward(const void* x, const float* ln1_g,
                          const float* ln1_b, const bf16* wqkv,
                          const float* bqkv, const bf16* wproj,
                          const float* bproj, const float* ln2_g,
                          const float* ln2_b, const bf16* w1, const float* b1,
                          const bf16* w2, const float* b2, float* xres,
                          bf16* xn, bf16* qkv, bf16* attn, float* x2,
                          bf16* hidden, void* out, int T, int B, int n_pad,
                          int D, int heads, int n_valid, int F, int x_f32,
                          float eps, float scale, int grid, void* stream) {
  const int hd = D / heads;
  NetKernel kernel = pick(x_f32, hd);
  if (!kernel || T < 1) return (int)cudaErrorInvalidValue;
  int dev, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const size_t smem = smem_bytes(n_pad, hd);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        GEMM_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  NetArgs a = {x,     ln1_g, ln1_b,  wqkv, bqkv,  wproj, bproj, ln2_g,
               ln2_b, w1,    b1,     w2,   b2,    xres,  xn,    qkv,
               attn,  x2,    hidden, out,  T,     B,     n_pad, D,
               heads, n_valid, F,    eps,  scale};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel),
      dim3(grid > 0 ? grid : per_sm * sms), dim3(GEMM_THREADS), args, smem,
      reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
