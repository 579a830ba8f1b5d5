// Fused transformer MLP for Hopper (sm_90a): optional LayerNorm -> fc1 ->
// exact-erf GELU -> fc2 -> optional residual, one launch, the [rows, H]
// hidden never written to device memory.
//
// Replaces the TPU kernel hipt_abmil_atec23_tpu/ops/fused_mlp.py _kernel
// (launcher _run). That kernel keeps both weight matrices resident in VMEM
// (2.4 MB at D=384, H=1536) and streams 512-row tiles. Here the weights
// stay in L2 and stream through shared memory; a persistent grid (one CTA
// per SM) walks 128-row tiles, each warpgroup 64 of the rows:
//
//   xs  = bf16(LN(x) or x)             [64, D] per warpgroup, shared memory
//   for each chunk c of HC = 64 hidden units:
//     h_c = GELU_erf(xs . W1[:, c] + b1[c])   [64, 64] f32, registers
//     acc += bf16(h_c) . W2[c, :]             [64, D] f32, registers
//   out = x.dtype((acc + b2) + x)     residual on the loaded x
//
// LN statistics, bias adds, GELU and the residual run in f32; the two
// products take bf16 operands (the normalised rows, the post-GELU hidden)
// with f32 accumulation, as the TPU's MXU rounds f32 operands at default
// precision. GELU's erf is the TPU kernel's (Abramowitz-Stegun 7.1.26,
// within 1.5e-7 of erff), its reciprocal and exponential on the
// special-function unit: with erff the GELUs cost more than either product
// (PERF.md, PR 8).
//
// The weights stream with TMA into a ring of S stages in the 128-byte
// swizzle wgmma reads, in the order both warpgroups use them: W1 chunk c
// (W1^T rows [64 c, 64 c + 64), DP / 64 k-tiles of [64][64], DP = D rounded
// up to 64, TMA zero-filling past D), then W2 chunk c (W2^T [DP rows][64
// cols]). Each warpgroup runs, per chunk: FC1 on wgmma m64n64k16 (A = its
// rows of xs, B = the W1 chunk), bias and GELU on the accumulators, the
// results packed to bf16 straight into wgmma's register A fragments, and
// FC2 on wgmma m64nNk16 with A from those registers (B = the W2 chunk, N =
// D in pieces of at most 192). The hidden touches neither device nor
// shared memory, and the two warpgroups never wait for each other: while
// one runs its GELU the other has the tensor cores. A stage is refilled by
// the last of the eight warps to finish with it (a shared counter), so no
// thread waits to load.
//
// Reckoning at D = 384 (the largest D), H any multiple of 64:
//   shared memory  xs 2 x 48 KB + 2 stages x 48 KB + 1 KB align = 193 KB of
//                  the 227 KB a CTA may have (D = 192: 7 stages of 24 KB,
//                  D <= 64: 8 of 8 KB)
//   registers      FC2 accumulator 64 x D / 128 = 192 a thread, FC1 32, the
//                  packed hidden 16; with 256 threads, one CTA per SM,
//                  ptxas may give each thread up to 255
//   operand reads  per warpgroup and k16, FC1 A 2 KB + B 2 KB from shared
//                  memory for 64K FMA; FC2 B 6 KB for 196K FMA
//
// Bound on this card: 4 * rows * D * H operations against 2 * rows * D
// bytes of rows in and out, so the tensor cores bound it (310 GFLOP, 0.314
// ms at the slice's [131584, 384], H = 1536). Every 128-row tile reads all
// of W1 and W2 (2.36 MB) from L2: ~2.4 GB at that shape.
#include "hopper.cuh"

namespace {

using namespace hk;

constexpr int WGS = 2;                          // warpgroups, 64 rows each
constexpr int MT = 64 * WGS;                    // rows per tile
constexpr int HC = 64;                          // hidden units per chunk
constexpr int THREADS = 128 * WGS;
constexpr int MAX_STAGES = 8;
constexpr uint32_t TILE_BYTES = 64 * 64 * sizeof(bf16);  // [64][64] bf16
constexpr size_t SMEM_LIMIT = 232448;           // per block on sm_90
constexpr int kMaxDevices = 64;

template <int D>
struct Cfg {
  static constexpr int DP = (D + 63) / 64 * 64;  // D padded to the swizzle
  static constexpr int KT = DP / 64;             // [64][64] tiles per stage
  static constexpr uint32_t STAGE = DP * 128;
  // both warpgroups' rows, slack to align the base to 1024 bytes, and the
  // static barriers and counters
  static constexpr size_t FIXED = (size_t)WGS * DP * 128 + 1024 + 256;
  static constexpr int FIT = (int)((SMEM_LIMIT - FIXED) / STAGE);
  static constexpr int S = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr size_t SMEM = FIXED - 256 + (size_t)S * STAGE;
  static_assert(S >= 2, "the ring needs two stages");
};

// x * 0.5 * (1 + erf(x / sqrt 2)) with the TPU kernel's erf
// (Abramowitz-Stegun 7.1.26, |error| <= 1.5e-7) on the special-function
// unit: one reciprocal and one exp2 per value, where erff costs a long
// polynomial and a branch
__device__ __forceinline__ float gelu_erf(float v) {
  const float x = v * 0.70710678118654752f, ax = fabsf(x);
  float t;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(fmaf(0.3275911f, ax, 1.f)));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f),
                               1.421413741f),
                       -0.284496736f),
               0.254829592f);
  const float e = copysignf(1.f - poly * ex2(-ax * ax * kLog2e), x);
  return v * 0.5f * (1.f + e);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// byte offset of bf16 element (r, c) in a run of [64][64] tiles laid out
// in the 128-byte swizzle (tile c / 64; in it row r at 128 r, its 16-byte
// chunk (c % 64) / 8 XOR r % 8)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  const int cc = c & 63;
  return (uint32_t)(c >> 6) * TILE_BYTES + r * 128 +
         ((((cc >> 3) ^ (r & 7))) << 4) + (cc & 7) * 2;
}

// A warpgroup's 64 rows at r0 into xs: bf16(LN(x)) with f32 statistics,
// or bf16(x); rows past R are zeros. Its 4 warps take two rows at a time;
// each lane holds four consecutive columns per 128.
template <int D>
__device__ __forceinline__ void load_rows(const bf16* x, const float* g,
                                          const float* b, unsigned char* xs,
                                          int r0, int R, int with_ln,
                                          float eps) {
  constexpr int V = (D + 127) / 128;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  for (int rr = 2 * warp; rr < 64; rr += 8) {
    float4 v[2][V];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + rr + h;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = 4 * (lane + 32 * i);
        if (m < R && c < D) {
          const uint2 u =
              *reinterpret_cast<const uint2*>(x + (size_t)m * D + c);
          const __nv_bfloat162* p =
              reinterpret_cast<const __nv_bfloat162*>(&u);
          const float2 lo = __bfloat1622float2(p[0]);
          const float2 hi = __bfloat1622float2(p[1]);
          v[h][i] = make_float4(lo.x, lo.y, hi.x, hi.y);
        } else {
          v[h][i] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rr + h;
      float mu = 0.f, rstd = 1.f;
      if (with_ln) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i)
          s += (v[h][i].x + v[h][i].y) + (v[h][i].z + v[h][i].w);
        mu = warp_sum(s) / D;
        float q = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (4 * (lane + 32 * i) < D) {
            const float a0 = v[h][i].x - mu, a1 = v[h][i].y - mu;
            const float a2 = v[h][i].z - mu, a3 = v[h][i].w - mu;
            q += a0 * a0 + a1 * a1 + a2 * a2 + a3 * a3;
          }
        }
        rstd = rsqrtf(warp_sum(q) / D + eps);
      }
      const bool live = r0 + r < R;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = 4 * (lane + 32 * i);
        if (c >= D) continue;
        float4 y = v[h][i];
        if (with_ln && live) {
          const float4 gg = *reinterpret_cast<const float4*>(g + c);
          const float4 bb = *reinterpret_cast<const float4*>(b + c);
          y = make_float4((y.x - mu) * rstd * gg.x + bb.x,
                          (y.y - mu) * rstd * gg.y + bb.y,
                          (y.z - mu) * rstd * gg.z + bb.z,
                          (y.w - mu) * rstd * gg.w + bb.w);
        }
        uint2 pk;
        pk.x = pack_bf16(y.x, y.y);
        pk.y = pack_bf16(y.z, y.w);
        *reinterpret_cast<uint2*>(xs + swz(r, c)) = pk;
      }
    }
  }
}

// columns [OFF, N) of a warpgroup's FC2 output: d[0 ..] += A[64 x 16] .
// B[rows OFF .. N)^T, A from registers, B K-major and swizzled with 128-byte
// rows, in pieces of at most 192 columns
template <int N, int OFF = 0>
__device__ __forceinline__ void fc2_cols(float (*d)[4], const uint32_t* a,
                                         uint64_t db) {
  constexpr int REM = N - OFF;
  if constexpr (REM > 0) {
    float(*o)[4] = d + OFF / 8;
    const uint64_t b = db + ((OFF * 128) >> 4);
    if constexpr (REM >= 192) {
      wgmma_m64n192k16_rs(*reinterpret_cast<float(*)[24][4]>(o), a, b);
      fc2_cols<N, OFF + 192>(d, a, db);
    } else if constexpr (REM >= 128) {
      wgmma_m64n128k16_rs(*reinterpret_cast<float(*)[16][4]>(o), a, b);
      fc2_cols<N, OFF + 128>(d, a, db);
    } else if constexpr (REM >= 96) {
      wgmma_m64n96k16_rs(*reinterpret_cast<float(*)[12][4]>(o), a, b);
      fc2_cols<N, OFF + 96>(d, a, db);
    } else if constexpr (REM >= 64) {
      wgmma_m64n64k16_rs(*reinterpret_cast<float(*)[8][4]>(o), a, b);
      fc2_cols<N, OFF + 64>(d, a, db);
    } else if constexpr (REM >= 32) {
      wgmma_m64n32k16_rs(*reinterpret_cast<float(*)[4][4]>(o), a, b);
      fc2_cols<N, OFF + 32>(d, a, db);
    } else {
      static_assert(REM == 16, "D is a multiple of 32");
      wgmma_m64n16k16_rs(*reinterpret_cast<float(*)[2][4]>(o), a, b);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_kernel(const __grid_constant__ CUtensorMap w1map,
                 const __grid_constant__ CUtensorMap w2map,
                 const bf16* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta,
                 const float* __restrict__ b1, const float* __restrict__ b2,
                 bf16* __restrict__ out, int R, int H, int with_ln,
                 int residual, float eps) {
  using C = Cfg<D>;
  constexpr int S = C::S;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[S];
  __shared__ int done[S];  // warps finished with each stage's fill
  unsigned char* ring = align1024(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  unsigned char* xs = ring + S * C::STAGE + wg * C::DP * 128;
  const int nc = H / HC;
  const int tiles = (R + MT - 1) / MT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    mbar_init_fence();
  }
  if constexpr (C::DP != D) {  // xs's padding columns stay zero (W1 is 0)
    constexpr int PAD = (C::DP - D) / 4;
    for (int e = threadIdx.x & 127; e < 64 * PAD; e += 128)
      *reinterpret_cast<uint2*>(xs + swz(e / PAD, D + 4 * (e % PAD))) =
          make_uint2(0u, 0u);
    fence_proxy_async();
  }
  __syncthreads();

  // Fill j of this CTA's sequence (per tile: W1(0), W2(0), W1(1), ...)
  // into stage j % S: a W1 chunk is W1^T [H, D] rows 64 c .., one k-tile
  // per 64 columns; a W2 chunk W2^T [D, H] columns 64 c .., one tile per 64
  // rows.
  const int my_tiles = (int)blockIdx.x < tiles
      ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const uint32_t fills = (uint32_t)my_tiles * 2 * nc;
  auto fill = [&](uint32_t j) {
    if (j >= fills) return;
    const int s = j % S, c = (j / 2) % nc;
    mbar_expect_tx(&full[s], C::STAGE);
    unsigned char* st = ring + s * C::STAGE;
    for (int t = 0; t < C::KT; ++t) {
      if (j & 1)
        tma_load_3d(st + t * TILE_BYTES, &w2map, &full[s], HC * c, 64 * t, 0);
      else
        tma_load_3d(st + t * TILE_BYTES, &w1map, &full[s], 64 * t, HC * c, 0);
    }
  };
  if (threadIdx.x == 0)
    for (uint32_t j = 0; j < (uint32_t)S; ++j) fill(j);
  auto wait_full = [&](uint32_t i) {
    mbar_wait(&full[i % S], (i / S) & 1);
  };
  // this warp is done with fill i (its products are complete); the last of
  // the eight warps refills the stage with fill i + S
  auto release = [&](uint32_t i) {
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&done[i % S], 1) == 4 * WGS - 1) {
        done[i % S] = 0;
        __threadfence_block();
        fill(i + S);
      }
    }
    __syncwarp();
  };

  const int wr = (warp & 3) * 16;      // this warp's 16 rows of the 64
  const int g = lane >> 2, t4 = lane & 3;
  const uint64_t dxs = swz_desc(xs, 128);
  float acc[D / 8][4];                 // out [64, D] of this warpgroup
  float ha[8][4];                      // FC1 of a chunk
  uint32_t hb[4][4];                   // bf16(GELU(h)) as FC2's A, per k16
  uint32_t it = 0;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * MT + 64 * wg;
    // this warpgroup's FC1 of the previous tile is done with xs
    named_sync(1 + wg, 128);
    load_rows<D>(x, gamma, beta, xs, r0, R, with_ln, eps);
    fence_proxy_async();  // generic stores, before wgmma reads them
    named_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int c = 0; c < nc; ++c, it += 2) {
      // FC1: h = xs . (W1 chunk c)^T over DP
      wait_full(it);
      const uint64_t db1 = swz_desc(ring + (it % S) * C::STAGE, 128);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < C::KT; ++t)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16(ha, dxs + ((t * TILE_BYTES) >> 4) + 2 * kk,
                          db1 + ((t * TILE_BYTES) >> 4) + 2 * kk,
                          (t | kk) != 0);
      wgmma_commit();
      wgmma_wait<0>();  // and the previous chunk's FC2
      fence_regs(ha);
      fence_regs(acc);
      if (c > 0) release(it - 1);
      release(it);
      // bias, GELU, bf16 pairs in the A-fragment order of m64nNk16: k16
      // step kk takes n8 blocks 2 kk (a0, a1) and 2 kk + 1 (a2, a3)
      const float* bias1 = b1 + (size_t)c * HC;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bias =
            *reinterpret_cast<const float2*>(bias1 + 8 * j + 2 * t4);
        hb[j / 2][2 * (j & 1)] = pack_bf16(gelu_erf(ha[j][0] + bias.x),
                                           gelu_erf(ha[j][1] + bias.y));
        hb[j / 2][2 * (j & 1) + 1] = pack_bf16(gelu_erf(ha[j][2] + bias.x),
                                               gelu_erf(ha[j][3] + bias.y));
      }
      // FC2: acc += h . (W2 chunk c)^T, A from registers
      wait_full(it + 1);
      const uint64_t db2 = swz_desc(ring + ((it + 1) % S) * C::STAGE, 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fc2_cols<D>(acc, hb[kk], db2 + 2 * kk);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(it - 1);

    // out = (acc + b2) (+ x), rows wr + g and + 8, columns 8 j + 2 t4 ..
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + wr + g + 8 * h;
      if (m >= R) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int n = 8 * j + 2 * t4;
        const float2 bias = *reinterpret_cast<const float2*>(b2 + n);
        float v0 = acc[j][2 * h] + bias.x, v1 = acc[j][2 * h + 1] + bias.y;
        const size_t idx = (size_t)m * D + n;
        if (residual) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + idx));
          v0 += r.x;
          v1 += r.y;
        }
        store_pair(out + idx, v0, v1);
      }
    }
  }
}

template <int D>
cudaError_t launch(const bf16* x, const float* g, const float* be,
                   const bf16* w1t, const float* b1, const bf16* w2t,
                   const float* b2, bf16* out, int R, int H, int with_ln,
                   int residual, float eps, cudaStream_t s) {
  using C = Cfg<D>;
  CUtensorMap w1map, w2map;
  if (!tensor_map_3d(&w1map, w1t, D, H, 1, 64, 64,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map_3d(&w2map, w2t, H, D, 1, 64, 64,
                     CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  auto kern = fused_mlp_kernel<D>;
  // the grid is the CTAs resident on the card at once (queried once per
  // device)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  static int resident[kMaxDevices];
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        THREADS, C::SMEM);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  const int tiles = (R + MT - 1) / MT;
  const int grid = tiles < resident[dev] ? tiles : resident[dev];
  kern<<<grid, THREADS, C::SMEM, s>>>(w1map, w2map, x, g, be, b1, b2, out,
                                      R, H, with_ln, residual, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fused_mlp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x, out [R, D] bf16; gamma, beta [D] f32 (null without LN); w1t = W1^T
// [H, D] and w2t = W2^T [D, H] bf16 (torch Linear layout: K contiguous,
// as wgmma reads both operands); b1 [H], b2 [D] f32. D a multiple of 32 up
// to 384, H a multiple of 64. One launch; returns the CUDA error.
int fused_mlp_forward(const bf16* x, const float* gamma, const float* beta,
                      const bf16* w1t, const float* b1, const bf16* w2t,
                      const float* b2, bf16* out, int R, int D, int H,
                      int with_ln, int residual, float eps, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (R == 0) return 0;
  if (D % 32 || D > 384 || H <= 0 || H % HC || (with_ln && (!gamma || !beta)))
    return (int)cudaErrorInvalidValue;
#define HK_CASE(nf)                                                          \
  case nf:                                                                   \
    return (int)launch<32 * nf>(x, gamma, beta, w1t, b1, w2t, b2, out, R, H, \
                                with_ln, residual, eps, s);
  switch (D / 32) {
    HK_CASE(1) HK_CASE(2) HK_CASE(3) HK_CASE(4) HK_CASE(5) HK_CASE(6)
    HK_CASE(7) HK_CASE(8) HK_CASE(9) HK_CASE(10) HK_CASE(11) HK_CASE(12)
  }
#undef HK_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
