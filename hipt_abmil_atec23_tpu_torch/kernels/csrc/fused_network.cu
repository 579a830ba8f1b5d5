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
// This kernel is a persistent cooperative grid instead: as many CTAs of the
// GEMM's shape (one TMA producer warp, two wgmma consumer warpgroups) as
// are co-resident, launched with cudaLaunchCooperativeKernel. It loops over
// the T blocks itself and walks B.1's seven stages (vit_block.cuh), with a
// grid-wide barrier (cooperative_groups::this_grid().sync()) after each:
//
//   LN1    xn = bf16(LN1(xres)), two rows per warp, as B.1's LayerNorm
//          launches; block 0 reads x and stores it to xres as f32
//   QKV    qkv = head-major bf16, q scaled in f32 before its cast
//   ATTN   per (image, head): K and V loaded once, every warp computing
//   PROJ   x2 = (xres + O . Wproj^T) + bproj          f32
//   LN2    xn = bf16(LN2(x2)), as LN1
//   FC1    h = bf16(GELU_erf(xn . W1^T + b1))
//   FC2    xres = (x2 + h . W2^T) + b2                f32; the last block
//                                                     stores out in x's dtype
//
// The GEMM stages take their tiles, and attention its heads, from atomic
// counters, so a CTA that runs ahead takes more and the barriers wait less.
// The stacked weights are read through 3-D TMA maps [T, N, K] whose depth
// coordinate is the block index. The copy ring's barriers are set up once
// and carry over from one GEMM stage to the next. The f32 residual and the
// stage intermediates live in caller-allocated device memory. Shared memory
// is the larger of the GEMM ring (~97 KB) and attention's K and V (~92 KB
// at 264 tokens, hd 64), so two CTAs fit on an SM.
//
// Bound on this card: the GEMMs are tensor-core work (6.2 TFLOP for
// ViT-256's 12 blocks on 512 images) against 0.25 GB that must move, so
// operations bound it.
//
// With a non-null ``clock``, CTA 0 stores %globaltimer (ns) at the start
// and on arriving at and leaving each grid barrier: clock[0] the start,
// clock[1 + 2 i] and clock[2 + 2 i] around barrier i = 7 t + stage.
#include <cooperative_groups.h>

#include "vit_block.cuh"

namespace cg = cooperative_groups;
using namespace vit;

namespace {

// grid barriers per block: after LN1, QKV, attention, PROJ, LN2, FC1, FC2
constexpr int STAGES_PER_BLOCK = 7;
// work counters per block: QKV tiles, heads, PROJ tiles, FC1 tiles, FC2
// tiles
constexpr int COUNTERS_PER_BLOCK = 5;

struct NetArgs {
  CUtensorMap m_xn;                   // xn [M, D] as a GEMM A operand
  CUtensorMap m_attn;                 // attn [M, D]
  CUtensorMap m_hidden;               // hidden [M, F]
  CUtensorMap m_wqkv;                 // [T, 3D, D]
  CUtensorMap m_wproj;                // [T, D, D]
  CUtensorMap m_w1;                   // [T, F, D]
  CUtensorMap m_w2;                   // [T, D, F]
  const void* x;                      // [B, n_pad, D] bf16 or f32
  const float *ln1_g, *ln1_b;         // [T, D]
  const float* bqkv;                  // [T, 3D]
  const float* bproj;                 // [T, D]
  const float *ln2_g, *ln2_b;         // [T, D]
  const float* b1;                    // [T, F]
  const float* b2;                    // [T, D]
  float* xres;                        // [M, D] f32 residual
  bf16* xn;                           // [M, D]
  bf16* qkv;                          // [3, B, H, n_pad, hd]
  bf16* attn;                         // [M, D]
  float* x2;                          // [M, D]
  bf16* hidden;                       // [M, F]
  void* out;                          // [B, n_pad, D], x's dtype
  int* counters;                      // [COUNTERS_PER_BLOCK * T] scratch
  unsigned long long* clock;          // null, or 1 + 14 T stamps
  int T, B, n_pad, D, heads, n_valid, F;
  float eps, scale;
};

// CTA 0's stamp of the time before or after grid barrier ``i``
__device__ __forceinline__ void stamp(const NetArgs& a, int idx) {
  if (a.clock && blockIdx.x == 0 && threadIdx.x == 0)
    a.clock[idx] = globaltimer();
}

__device__ __forceinline__ void barrier(const NetArgs& a, cg::grid_group& g,
                                        int i) {
  stamp(a, 1 + 2 * i);
  g.sync();
  stamp(a, 2 + 2 * i);
}

// two rows per warp (row, row + the grid's warps) over the grid's warps;
// with ``copy`` set the rows are also stored there as f32
template <typename TIn>
__device__ __forceinline__ void layernorm_stage(const TIn* x, const float* g,
                                                const float* b, bf16* y,
                                                int M, int D, float eps,
                                                float* copy) {
  const int warps = gridDim.x * (blockDim.x >> 5);
  for (int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       row < M; row += 2 * warps)
    layernorm_rows2<TIn>(x, g, b, y, D, eps, row, row + warps, M, copy);
}

template <typename TX, int HD>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
network_kernel(const __grid_constant__ NetArgs a) {
  __shared__ __align__(8) uint64_t bars[2 * GEMM_STAGES];
  __shared__ int slots[GEMM_STAGES];
  __shared__ int head_unit;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  cg::grid_group grid = cg::this_grid();
  Ring ring = ring_init(bars, slots);
  const int D = a.D, F = a.F, M = a.B * a.n_pad;
  stamp(a, 0);
  // the work counters start at 0; the first barrier orders this before
  // any CTA takes work
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < COUNTERS_PER_BLOCK * a.T; i += blockDim.x)
      a.counters[i] = 0;

  for (int t = 0; t < a.T; ++t) {
    const size_t tv = (size_t)t * D;
    int* counter = a.counters + COUNTERS_PER_BLOCK * t;
    const int bi = STAGES_PER_BLOCK * t;  // this block's first barrier
    if (t == 0)  // block 0 reads x and keeps it as the f32 residual
      layernorm_stage<TX>(static_cast<const TX*>(a.x), a.ln1_g, a.ln1_b,
                          a.xn, M, D, a.eps, a.xres);
    else
      layernorm_stage<float>(a.xres, a.ln1_g + tv, a.ln1_b + tv, a.xn, M, D,
                             a.eps, nullptr);
    barrier(a, grid, bi);

    EpiArgs ep = {};
    ep.bias = a.bqkv + (size_t)t * 3 * D;
    ep.qkv = a.qkv;
    ep.batch = a.B;
    ep.n_pad = a.n_pad;
    ep.heads = a.heads;
    ep.hd = HD;
    ep.dim = D;
    ep.scale = a.scale;
    gemm_tiles<EPI_QKV>(&a.m_xn, &a.m_wqkv, t, M, 3 * D, D, ep, smem, ring,
                        Sched{0, 0, counter});
    barrier(a, grid, bi + 1);

    for (;;) {
      if (threadIdx.x == 0) head_unit = atomicAdd(counter + 1, 1);
      __syncthreads();
      const int u = head_unit;  // attention_head syncs before it is reused
      if (u >= a.B * a.heads) break;
      attention_head<HD>(a.qkv, a.attn, a.B, a.heads, a.n_pad, a.n_valid,
                         u % a.heads, u / a.heads, smem);
    }
    barrier(a, grid, bi + 2);

    ep = EpiArgs{};
    ep.bias = a.bproj + tv;
    ep.res_f32 = a.xres;
    ep.out_f32 = a.x2;
    gemm_tiles<EPI_PROJ>(&a.m_attn, &a.m_wproj, t, M, D, D, ep, smem, ring,
                         Sched{0, 0, counter + 2});
    barrier(a, grid, bi + 3);

    layernorm_stage<float>(a.x2, a.ln2_g + tv, a.ln2_b + tv, a.xn, M, D,
                           a.eps, nullptr);
    barrier(a, grid, bi + 4);

    ep = EpiArgs{};
    ep.bias = a.b1 + (size_t)t * F;
    ep.out_bf16 = a.hidden;
    gemm_tiles<EPI_FC1>(&a.m_xn, &a.m_w1, t, M, F, D, ep, smem, ring,
                        Sched{0, 0, counter + 3});
    barrier(a, grid, bi + 5);

    ep = EpiArgs{};
    ep.bias = a.b2 + tv;
    ep.res_f32 = a.x2;
    if (t + 1 < a.T)
      ep.out_f32 = a.xres;
    else if (sizeof(TX) == sizeof(float))
      ep.out_f32 = static_cast<float*>(a.out);
    else
      ep.out_bf16 = static_cast<bf16*>(a.out);
    gemm_tiles<EPI_FC2>(&a.m_hidden, &a.m_w2, t, M, D, F, ep, smem, ring,
                        Sched{0, 0, counter + 4});
    barrier(a, grid, bi + 6);
  }
}

typedef void (*NetKernel)(const NetArgs);

NetKernel pick(int x_f32, int hd) {
  if (hd == 64)
    return x_f32 ? &network_kernel<float, 64> : &network_kernel<bf16, 64>;
  if (hd == 32)
    return x_f32 ? &network_kernel<float, 32> : &network_kernel<bf16, 32>;
  return nullptr;
}

size_t smem_bytes(int n_pad, int hd) {
  const size_t att = att_smem(n_pad, hd) + 1024;  // behind the aligned base
  return att > GEMM_SMEM ? att : GEMM_SMEM;
}

}  // namespace

extern "C" {

// dynamic shared memory per CTA at this token count and head size, so the
// caller can refuse shapes past the card's 227 KB per block
size_t fused_network_smem(int n_pad, int hd) { return smem_bytes(n_pad, hd); }

// grid-barrier timestamps one clocked launch writes
int fused_network_clock_len(int T) { return 1 + 2 * STAGES_PER_BLOCK * T; }

// int32 work counters the caller allocates for one launch
int fused_network_counters_len(int T) { return COUNTERS_PER_BLOCK * T; }

const char* fused_network_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x, out [B, n_pad, D], both bf16 (x_f32 = 0) or both f32 (x_f32 = 1);
// stacked Linear weights bf16 in torch [out, in] layout per block
// ([T, 3D, D], [T, D, D], [T, F, D], [T, D, F]); LayerNorm parameters and
// biases f32 [T, *]. Scratch (caller-allocated): xres [M, D] f32, xn [M, D]
// bf16, qkv [3, B, H, n_pad, hd] bf16, attn [M, D] bf16, x2 [M, D] f32,
// hidden [M, F] bf16, counters fused_network_counters_len(T) int32 (any
// contents); scale = hd^-1/2. ``clock``: null, or
// fused_network_clock_len(T) int64 on the device for the stage timer.
// ``grid`` CTAs, or with grid <= 0 all that are co-resident; a grid past
// that fails the cooperative launch. Returns the first CUDA error
// (cudaErrorInvalidValue also when the driver refuses a TMA map); the kernel
// never runs on an error.
int fused_network_forward(const void* x, const float* ln1_g,
                          const float* ln1_b, const bf16* wqkv,
                          const float* bqkv, const bf16* wproj,
                          const float* bproj, const float* ln2_g,
                          const float* ln2_b, const bf16* w1, const float* b1,
                          const bf16* w2, const float* b2, float* xres,
                          bf16* xn, bf16* qkv, bf16* attn, float* x2,
                          bf16* hidden, void* out, int* counters, void* clock,
                          int T, int B,
                          int n_pad, int D, int heads, int n_valid, int F,
                          int x_f32, float eps, float scale, int grid,
                          void* stream) {
  const int hd = D / heads, M = B * n_pad;
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
  NetArgs a = {};
  if (!tile_map(&a.m_xn, xn, D, M, 1) || !tile_map(&a.m_attn, attn, D, M, 1) ||
      !tile_map(&a.m_hidden, hidden, F, M, 1) ||
      !tile_map(&a.m_wqkv, wqkv, D, 3 * D, T) ||
      !tile_map(&a.m_wproj, wproj, D, D, T) ||
      !tile_map(&a.m_w1, w1, D, F, T) || !tile_map(&a.m_w2, w2, F, D, T))
    return (int)cudaErrorInvalidValue;
  a.x = x;
  a.ln1_g = ln1_g;
  a.ln1_b = ln1_b;
  a.bqkv = bqkv;
  a.bproj = bproj;
  a.ln2_g = ln2_g;
  a.ln2_b = ln2_b;
  a.b1 = b1;
  a.b2 = b2;
  a.xres = xres;
  a.xn = xn;
  a.qkv = qkv;
  a.attn = attn;
  a.x2 = x2;
  a.hidden = hidden;
  a.out = out;
  a.counters = counters;
  a.clock = static_cast<unsigned long long*>(clock);
  a.T = T;
  a.B = B;
  a.n_pad = n_pad;
  a.D = D;
  a.heads = heads;
  a.n_valid = n_valid;
  a.F = F;
  a.eps = eps;
  a.scale = scale;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel),
      dim3(grid > 0 ? grid : per_sm * sms), dim3(GEMM_THREADS), args, smem,
      reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
