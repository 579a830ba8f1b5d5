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
//   pass 1, per tile (256 threads, warp w owns rows 8w..8w+7):
//     h = relu(x W_f + b_f)  [64, L], kept transposed in shared memory;
//     z_a = h W_a + b_a, z_b = h W_b + b_b  [64, D_att] in column chunks,
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
// Both products are register-tiled f32 FMA on the CUDA cores (8 rows by
// CPT columns per thread, operands staged through shared memory in 32-deep
// chunks), as the TPU kernel upcasts the bag to f32. At the reference CLAM
// widths (D_in 1024, L 512, D_att 256) a bag costs ~1.6 MFLOP per instance
// against 4 KB read, so the kernel is bound by f32 operations; at the HIPT
// widths (192, 16, 8) by reading the bag. Shared memory holds the [L, 64]
// h tile (128 KB at L = 512), which caps L at ~690; any D_in and D_att fit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int TILE = 64;         // instances per tile
constexpr int THREADS = 256;     // 8 warps
constexpr int ROWS = 8;          // rows per warp
constexpr int KC = 32;           // reduction depth per staged chunk
constexpr int XP = TILE + 4;     // row stride of the transposed tiles
constexpr int MAX_PARTS = 1024;  // pass-1 CTAs, one partial each
constexpr size_t SMEM_LIMIT = 232448;  // per block on sm_90
constexpr int kMaxDevices = 64;        // host-side query caches
constexpr int kMaxCachedL = 1024;

__host__ __device__ constexpr int cpt_for(int L, int Da) {
  return (L <= 32 && Da <= 32) ? 1 : 4;
}

// floats of dynamic shared memory pass 1 needs
__host__ __device__ constexpr size_t smem_floats(int L, int cpt) {
  return (size_t)L * XP + KC * XP + 2 * KC * 32 * cpt + L + 2 * TILE;
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

// part: [gridDim.x][2 + L] = (m, l, acc[0..L)) of each CTA
template <int CPT>
__global__ void __launch_bounds__(THREADS)
pool_pass1(const float* __restrict__ bag, const uint8_t* __restrict__ mask,
           int n_valid, int N, int Din, int L, int Da,
           const float* __restrict__ wf, const float* __restrict__ bf,
           const float* __restrict__ wa, const float* __restrict__ ba,
           const float* __restrict__ wb, const float* __restrict__ bb,
           const float* __restrict__ wc, const float* __restrict__ bc,
           float* __restrict__ scores, float* __restrict__ part) {
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

template <int CPT>
cudaError_t launch_pass1(const float* bag, const uint8_t* mask, int n_valid,
                         int N, int Din, int L, int Da, const float* wf,
                         const float* bf, const float* wa, const float* ba,
                         const float* wb, const float* bb, const float* wc,
                         const float* bc, float* scores, float* part,
                         int* parts, cudaStream_t s) {
  const size_t smem = smem_floats(L, CPT) * sizeof(float);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  auto kern = pool_pass1<CPT>;
  // the grid is the CTAs resident on the card at once; the queries behind
  // it are cached per device and head width (a few us each per call)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  static int set_smem[kMaxDevices], sms_of[kMaxDevices];
  static int per_sm_of[kMaxDevices][kMaxCachedL + 1];
  if (set_smem[dev] < (int)smem) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    set_smem[dev] = (int)smem;
  }
  if (sms_of[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  int per_sm = L <= kMaxCachedL ? per_sm_of[dev][L] : 0;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        THREADS, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    if (L <= kMaxCachedL) per_sm_of[dev][L] = per_sm;
  }
  const int sms = sms_of[dev];
  const int tiles = (N + TILE - 1) / TILE;
  int p = per_sm * sms;
  if (p > tiles) p = tiles;
  if (p > MAX_PARTS) p = MAX_PARTS;
  *parts = p;
  kern<<<p, THREADS, smem, s>>>(bag, mask, n_valid, N, Din, L, Da, wf, bf, wa,
                                ba, wb, bb, wc, bc, scores, part);
  return cudaGetLastError();
}

cudaError_t run_pass1(const float* bag, const uint8_t* mask, int n_valid,
                      int N, int Din, int L, int Da, const float* wf,
                      const float* bf, const float* wa, const float* ba,
                      const float* wb, const float* bb, const float* wc,
                      const float* bc, float* scores, float* part, int* parts,
                      cudaStream_t s) {
  if (N <= 0 || Din <= 0 || L <= 0 || Da <= 0) return cudaErrorInvalidValue;
  if (cpt_for(L, Da) == 1)
    return launch_pass1<1>(bag, mask, n_valid, N, Din, L, Da, wf, bf, wa, ba,
                           wb, bb, wc, bc, scores, part, parts, s);
  return launch_pass1<4>(bag, mask, n_valid, N, Din, L, Da, wf, bf, wa, ba,
                         wb, bb, wc, bc, scores, part, parts, s);
}

}  // namespace

extern "C" {

int gated_pool_tile(void) { return TILE; }

int gated_pool_max_parts(void) { return MAX_PARTS; }

// Dynamic shared memory pass 1 needs for a head (L, D_att), or 0 when it is
// more than a block may have (the kernel does not take that head).
int gated_pool_smem_bytes(int L, int Da) {
  const size_t smem = smem_floats(L, cpt_for(L, Da)) * sizeof(float);
  return smem > SMEM_LIMIT ? 0 : (int)smem;
}

const char* gated_pool_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// bag [N, Din] f32; mask [N] uint8 or null (then rows < n_valid are valid);
// weights f32 in [in, out] layout: wf [Din, L], wa/wb [L, Da], wc [Da],
// wcls [L, C]. Outputs: scores [N], logits [C]; part scratch
// [min(tiles, max_parts), 2 + L]. Returns the first CUDA error.
int gated_pool_forward(const float* bag, const uint8_t* mask, int n_valid,
                       int N, int Din, int L, int Da, int C, const float* wf,
                       const float* bf, const float* wa, const float* ba,
                       const float* wb, const float* bb, const float* wc,
                       const float* bc, const float* wcls, const float* bcls,
                       float* scores, float* part, float* logits,
                       void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int parts = 0;
  cudaError_t err = run_pass1(bag, mask, n_valid, N, Din, L, Da, wf, bf, wa,
                              ba, wb, bb, wc, bc, scores, part, &parts, s);
  if (err != cudaSuccess) return (int)err;
  pool_combine<<<1, THREADS, L * sizeof(float), s>>>(
      part, parts, L, C, wcls, bcls, logits, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// The shard-local partial of the same pooling (the TPU kernel's partial_out
// mode): acc [L], the weighted sum of h at the bag's score max, unnormalised;
// ml = (m, l), that max (-1e30 when no row is valid) and the sum of the
// weights (0 then). Scores and scratch as gated_pool_forward.
int gated_pool_partial(const float* bag, const uint8_t* mask, int n_valid,
                       int N, int Din, int L, int Da, const float* wf,
                       const float* bf, const float* wa, const float* ba,
                       const float* wb, const float* bb, const float* wc,
                       const float* bc, float* scores, float* part,
                       float* acc, float* ml, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int parts = 0;
  cudaError_t err = run_pass1(bag, mask, n_valid, N, Din, L, Da, wf, bf, wa,
                              ba, wb, bb, wc, bc, scores, part, &parts, s);
  if (err != cudaSuccess) return (int)err;
  pool_combine<<<1, THREADS, 0, s>>>(part, parts, L, 0, nullptr, nullptr,
                                     nullptr, acc, ml);
  return (int)cudaGetLastError();
}

}  // extern "C"
