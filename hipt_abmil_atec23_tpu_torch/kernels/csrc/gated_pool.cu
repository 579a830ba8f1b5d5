// Gated-attention MIL pooling (CLAM_SB's Attn_Net_Gated + bag classifier)
// over a whole bag, for Hopper (sm_90a).
//
// Replaces the TPU kernel hipt_abmil_atec23_tpu/ops/gated_attention_pool.py
// _kernel (launcher _pallas_pool). On the TPU the grid walks the instance
// tiles in order and carries the online-softmax state (m, l, acc) from one
// step to the next; blocks here run in parallel and in no order, so the
// reduction is two passes:
//
//   pass 1, one CTA per 128-instance tile, one thread per instance:
//     h = relu(x W_f + b_f), a = tanh(h W_a + b_a), g = sigmoid(h W_b + b_b),
//     s = (a * g) w_c + b_c; invalid rows get s = -1e30 and are written to
//     scores[N]; the tile's partial (m, l = sum e, acc = sum e h) with
//     e = exp(s - m) for valid rows and exactly 0 for masked ones (also while
//     m is still -1e30, so an all-masked bag pools nothing).
//   pass 2, one CTA: m_g = max m, l_g = sum l e^(m - m_g),
//     M = sum acc e^(m - m_g) / max(l_g, 1e-30), logits = M W_cls + b_cls.
//
// All math is f32, as the TPU kernel upcasts the bag. Bound on this card:
// reading the bag once (N x D_in f32) from device memory; the arithmetic is
// ~2 D_in L FLOPs per instance. The tile and W_f stream through shared
// memory in 32-column chunks so any D_in fits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int TILE = 128;      // instances per CTA, one per thread
constexpr int KC = 32;         // D_in columns per shared-memory chunk
constexpr int P2_THREADS = 256;

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
__device__ float block_reduce(float v, float* red, int nwarps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < nwarps; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// part: [tiles][2 + L] = (m, l, acc[0..L))
template <int LM>
__global__ void __launch_bounds__(TILE)
pool_pass1(const float* __restrict__ bag, const uint8_t* __restrict__ mask,
           int n_valid, int N, int Din, int L, int Da,
           const float* __restrict__ wf, const float* __restrict__ bf,
           const float* __restrict__ wa, const float* __restrict__ ba,
           const float* __restrict__ wb, const float* __restrict__ bb,
           const float* __restrict__ wc, const float* __restrict__ bc,
           float* __restrict__ scores, float* __restrict__ part) {
  __shared__ float xs[TILE][KC + 1];
  __shared__ float ws[KC][LM];
  __shared__ float red[TILE / 32];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TILE;
  const int row = row0 + tid;

  float h[LM];
#pragma unroll
  for (int l = 0; l < LM; ++l) h[l] = 0.f;

  for (int k0 = 0; k0 < Din; k0 += KC) {
    __syncthreads();
    for (int e = tid; e < TILE * KC; e += TILE) {
      const int r = e / KC, c = e % KC;
      xs[r][c] = (row0 + r < N && k0 + c < Din)
                     ? bag[(size_t)(row0 + r) * Din + k0 + c]
                     : 0.f;
    }
    for (int e = tid; e < KC * LM; e += TILE) {
      const int kk = e / LM, l = e % LM;
      ws[kk][l] = (k0 + kk < Din && l < L) ? wf[(size_t)(k0 + kk) * L + l] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      const float xv = xs[tid][kk];
#pragma unroll
      for (int l = 0; l < LM; ++l) h[l] = fmaf(xv, ws[kk][l], h[l]);
    }
  }

#pragma unroll
  for (int l = 0; l < LM; ++l) h[l] = l < L ? fmaxf(h[l] + bf[l], 0.f) : 0.f;
  float s = bc[0];
  for (int d = 0; d < Da; ++d) {
    float za = ba[d], zb = bb[d];
#pragma unroll
    for (int l = 0; l < LM; ++l) {
      if (l < L) {
        za = fmaf(h[l], wa[l * Da + d], za);
        zb = fmaf(h[l], wb[l * Da + d], zb);
      }
    }
    s = fmaf(tanhf(za) * (1.f / (1.f + expf(-zb))), wc[d], s);
  }
  const bool valid =
      row < N && (mask != nullptr ? mask[row] != 0 : row < n_valid);
  if (!valid) s = kNegInf;
  if (row < N) scores[row] = s;

  const float m = block_reduce<true>(s, red, TILE / 32);
  const float e = s > 0.5f * kNegInf ? expf(s - m) : 0.f;
  const float l_sum = block_reduce<false>(e, red, TILE / 32);
  float* out = part + (size_t)blockIdx.x * (2 + L);
  if (tid == 0) {
    out[0] = m;
    out[1] = l_sum;
  }
#pragma unroll
  for (int l = 0; l < LM; ++l) {
    if (l < L) {
      const float a = block_reduce<false>(e * h[l], red, TILE / 32);
      if (tid == 0) out[2 + l] = a;
    }
  }
}

template <int LM>
__global__ void __launch_bounds__(P2_THREADS)
pool_pass2(const float* __restrict__ part, int tiles, int L, int C,
           const float* __restrict__ wcls, const float* __restrict__ bcls,
           float* __restrict__ logits) {
  __shared__ float red[P2_THREADS / 32];
  __shared__ float pooled[LM];
  const int tid = threadIdx.x;
  float m = kNegInf;
  for (int t = tid; t < tiles; t += P2_THREADS)
    m = fmaxf(m, part[(size_t)t * (2 + L)]);
  const float mg = block_reduce<true>(m, red, P2_THREADS / 32);

  float l_loc = 0.f, acc[LM];
#pragma unroll
  for (int l = 0; l < LM; ++l) acc[l] = 0.f;
  for (int t = tid; t < tiles; t += P2_THREADS) {
    const float* p = part + (size_t)t * (2 + L);
    const float w = expf(p[0] - mg);
    l_loc = fmaf(p[1], w, l_loc);
#pragma unroll
    for (int l = 0; l < LM; ++l)
      if (l < L) acc[l] = fmaf(p[2 + l], w, acc[l]);
  }
  const float lg = block_reduce<false>(l_loc, red, P2_THREADS / 32);
  const float inv = 1.f / fmaxf(lg, 1e-30f);
#pragma unroll
  for (int l = 0; l < LM; ++l) {
    if (l < L) {
      const float a = block_reduce<false>(acc[l], red, P2_THREADS / 32);
      if (tid == 0) pooled[l] = a * inv;
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += P2_THREADS) {
    float z = bcls[c];
    for (int l = 0; l < L; ++l) z = fmaf(pooled[l], wcls[l * C + c], z);
    logits[c] = z;
  }
}

template <int LM>
cudaError_t launch(const float* bag, const uint8_t* mask, int n_valid, int N,
                   int Din, int L, int Da, int C, const float* wf,
                   const float* bf, const float* wa, const float* ba,
                   const float* wb, const float* bb, const float* wc,
                   const float* bc, const float* wcls, const float* bcls,
                   float* scores, float* part, float* logits,
                   cudaStream_t s) {
  const int tiles = (N + TILE - 1) / TILE;
  pool_pass1<LM><<<tiles, TILE, 0, s>>>(bag, mask, n_valid, N, Din, L, Da, wf,
                                        bf, wa, ba, wb, bb, wc, bc, scores,
                                        part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pool_pass2<LM><<<1, P2_THREADS, 0, s>>>(part, tiles, L, C, wcls, bcls,
                                          logits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gated_pool_tile(void) { return TILE; }

const char* gated_pool_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// bag [N, Din] f32; mask [N] uint8 or null (then rows < n_valid are valid);
// weights f32 in [in, out] layout: wf [Din, L], wa/wb [L, Da], wc [Da],
// wcls [L, C]. Outputs: scores [N], logits [C]; part [tiles, 2 + L] scratch.
// L <= 128. Returns the first CUDA error.
int gated_pool_forward(const float* bag, const uint8_t* mask, int n_valid,
                       int N, int Din, int L, int Da, int C, const float* wf,
                       const float* bf, const float* wa, const float* ba,
                       const float* wb, const float* bb, const float* wc,
                       const float* bc, const float* wcls, const float* bcls,
                       float* scores, float* part, float* logits,
                       void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  if (L <= 16)
    err = launch<16>(bag, mask, n_valid, N, Din, L, Da, C, wf, bf, wa, ba, wb,
                     bb, wc, bc, wcls, bcls, scores, part, logits, s);
  else if (L <= 32)
    err = launch<32>(bag, mask, n_valid, N, Din, L, Da, C, wf, bf, wa, ba, wb,
                     bb, wc, bc, wcls, bcls, scores, part, logits, s);
  else if (L <= 64)
    err = launch<64>(bag, mask, n_valid, N, Din, L, Da, C, wf, bf, wa, ba, wb,
                     bb, wc, bc, wcls, bcls, scores, part, logits, s);
  else if (L <= 128)
    err = launch<128>(bag, mask, n_valid, N, Din, L, Da, C, wf, bf, wa, ba,
                      wb, bb, wc, bc, wcls, bcls, scores, part, logits, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
