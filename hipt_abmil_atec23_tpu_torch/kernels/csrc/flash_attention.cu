// Attention softmax(q k^T d^-1/2) v over [BH, N, d] bf16 for Hopper (sm_90a),
// keys at or past n_valid masked to -1e30. Two kernels on wgmma fed by TMA;
// the PTX, the TMA map encoder and the softmax step come from hopper.cuh.
//
// fused_attention_kernel replaces the TPU kernel
//   hipt_abmil_atec23_tpu/ops/flash_attention.py _fused_attn_kernel
//   (launcher fused_attention): scores in f32 from the bf16 operands, scaled
//   after the product, a full-row f32 softmax, P = bf16(e / sum e) and an f32
//   P . V. That kernel keeps a head group's whole K and V resident in up to
//   64 MiB of VMEM. Here the same rounding points take two passes over the
//   keys: f32 row max and sum of exp, then P and P . V. A warpgroup takes
//   64 query rows: its Q block by TMA into its own buffer, S = Q K^T on
//   wgmma (both K-major in shared memory) in 128-key (pass 1) and 64-key
//   (pass 2) chunks, then 16-key chunks to n_valid rounded to 16; P packed
//   to bf16 in registers as the A operand of O += P V (V MN-major); O in
//   registers.
//   Persistent CTAs of three warpgroups and one producer warp walk work
//   items, each a head (or, with fewer heads than SMs, a share of a head's
//   64-row query blocks). The producer copies an item's K and V with TMA
//   (16-row boxes, the 2 hd-byte swizzle wgmma reads, zeros past N) into
//   one of two stages while the warpgroups compute the item before it; the
//   warpgroups take the query blocks of the CTA's items in one stream, so a
//   head's last block and the next head's first run side by side. Past the
//   keys two stages hold (400 at hd 64, 848 at hd 32: the TPU wrapper's
//   query-tiled branch, N up to 49152 at hd 64) the items are blocks of 192
//   query rows, and 64-key chunks of K (pass 1) and of K and V (pass 2)
//   stream through a ring of eight stages.
//
// flash_attention_kernel replaces the TPU kernel
//   hipt_abmil_atec23_tpu/ops/flash_attention.py _flash_kernel (launcher
//   flash_attention): one pass with the online-softmax recurrence in f32 (m,
//   l, and the accumulator rescaled by alpha = exp(m_prev - m_new)), p not
//   normalised before P . V, the division by max(l, 1e-30) at the end. The
//   TPU kernel multiplies in f32 on the MXU, which rounds f32 operands to
//   bf16 at default precision; here p rounds to bf16 for the product and l
//   sums the f32 p. A CTA takes 128 query rows: one lane of a producer
//   warpgroup loads Q once and 128-key tiles of K and V through a 4-stage
//   TMA ring (full / empty mbarriers) and the warpgroup hands its
//   registers to the two consumer warpgroups (setmaxnreg). A consumer
//   warpgroup of 64 rows runs S = Q K^T on wgmma m64n128k16 (Q and K
//   K-major from shared memory), keeps S, m, l and alpha in registers,
//   packs P to bf16 in registers as the A operand of O += P V (wgmma
//   m64n{hd}k16, V MN-major) and keeps O in registers. Each warpgroup
//   issues tile j's S product before tile j - 1's P . V and runs its
//   softmax while both are in flight; the two warpgroups take turns at the
//   tensor cores (named barriers), so one's exponentials overlap the
//   other's products.
//
// Bound on this card: at the ViT's N = 257, d = 64 the two-pass kernel moves
// 4 BH N d bf16 (q, k, v in, o out) for ~6 BH N^2 d operations, below the
// card's ~295 operations per byte: bytes bound it, and the exponentials
// (2 BH N^2 on the special-function unit's 16 per clock per SM) come close;
// what sets its pace is each warpgroup's chain of products and softmax,
// so three warpgroups share an SM. At the flash branch's N = 65536
// operations bound it, and its N^2 exponentials take about as long as its
// tensor-core products; the softmax between a warpgroup's products holds
// it near 55% of the tensor-core rate even without the exponentials.
#include <limits.h>

#include <algorithm>

#include "hopper.cuh"

using namespace hk;

namespace {

// ---------------------------------------------------------------- wgmma
// S = Q K[k0 .. k0 + 8 NT)^T for a warpgroup's 64 query rows, Q (its
// descriptor dq) and K (the swizzled tile row k0 at ``K``) K-major in
// shared memory; issued and committed
template <int HD, int NT>
__device__ __forceinline__ void qk_issue(float (&s)[NT][4], uint64_t dq,
                                         const unsigned char* K) {
  const uint64_t dk = swz_desc(K, HD * sizeof(bf16));
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {  // 32 bytes along d per step
    if constexpr (NT == 16)
      wgmma_m64n128k16(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
    else if constexpr (NT == 8)
      wgmma_m64n64k16(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
    else
      wgmma_m64n16k16(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
  }
  wgmma_commit();
}

// the same, waited for
template <int HD, int NT>
__device__ __forceinline__ void wg_scores(float (&s)[NT][4], uint64_t dq,
                                          const unsigned char* K) {
  qk_issue<HD, NT>(s, dq, K);
  wgmma_wait<0>();
  fence_regs(s);
}

// O += P V[k0 .. k0 + 8 NT), P from registers (p[4 kk .. 4 kk + 3]: keys
// k0 + 16 kk ..), V MN-major from the swizzled tile row k0 at ``V``;
// issued and committed, not waited for
template <int HD, int NT>
__device__ __forceinline__ void pv_issue(float (&o)[HD / 8][4],
                                         const uint32_t (&p)[2 * NT],
                                         const unsigned char* V) {
  const uint64_t dv = swz_desc(V, HD * sizeof(bf16));
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {  // 16 key rows per step
    const uint64_t d = dv + kk * ((16 * HD * sizeof(bf16)) >> 4);
    if constexpr (HD == 64)
      wgmma_m64n64k16_rm(o, &p[4 * kk], d);
    else
      wgmma_m64n32k16_rm(o, &p[4 * kk], d);
  }
  wgmma_commit();
}

// ---------------------------------------------------------------- B.6
namespace fused {
constexpr int WGS = 3;                     // consumer warpgroups
constexpr int WARPS = 4 * WGS;             // consumer warps
constexpr int THREADS = 32 * (WARPS + 1);  // + the producer: 128 registers
constexpr int BOX = 16;                      // TMA box rows
constexpr int CHUNK = 64;                    // streamed keys per stage
constexpr int RING = 8;                      // streamed stages
constexpr size_t SMEM_MAX = 232448 - 256;    // less the barriers

// dynamic shared memory: the stages, each warpgroup's 64-row Q block, and
// slack to align the base to 1024 bytes. Resident: two stages of K and V
// over the first ``rows`` keys; streamed: RING stages of CHUNK keys.
__host__ __device__ inline size_t q_smem(int hd) {
  return (size_t)WGS * 64 * hd * sizeof(bf16) + 1024;
}
__host__ __device__ inline size_t resident_smem(int rows, int hd) {
  return 4 * (size_t)rows * hd * sizeof(bf16) + q_smem(hd);
}
__host__ __device__ inline size_t streamed_smem(int hd) {
  return (size_t)RING * 2 * CHUNK * hd * sizeof(bf16) + q_smem(hd);
}

// this warpgroup's 64-row Q block (rows row0 .. of head ``head``) into its
// buffer by TMA: a named barrier first, so no warp of the warpgroup still
// reads the block before; returns the block's descriptor
template <int HD>
__device__ __forceinline__ uint64_t load_q_block(unsigned char* buf,
                                                 const CUtensorMap* qmap,
                                                 uint64_t* bar, uint32_t& ph,
                                                 int row0, int head) {
  const int wg = threadIdx.x >> 7;
  named_sync(1 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
    mbar_expect_tx(bar, 64 * HD * sizeof(bf16));
    tma_load_3d(buf, qmap, bar, 0, row0, head);
  }
  mbar_wait(bar, ph);
  ph ^= 1;
  return swz_desc(buf, HD * sizeof(bf16));
}

// pass 1 over the keys [k0, k0 + 8 NT) of tile K: the online row max m
// (times c) and this lane's share of the sum l
template <int HD, int NT>
__device__ __forceinline__ void stats_chunk(float (&m)[2], float (&l)[2],
                                            uint64_t dq,
                                            const unsigned char* K, int k0,
                                            int n_valid, float c) {
  float s[NT][4], alpha[2];
  wg_scores<HD, NT>(s, dq, K + k0 * HD * sizeof(bf16));
  softmax_step<NT>(s, m, l, alpha, k0, n_valid, c);
}

// pass 2 over the keys [k0, k0 + 8 NT): P = bf16(exp2(s c - mm)) = bf16(e
// / sum e), O += P V in f32
template <int HD, int NT>
__device__ __forceinline__ void pv_chunk(float (&o)[HD / 8][4],
                                         const float (&mm)[2], uint64_t dq,
                                         const unsigned char* K,
                                         const unsigned char* V, int k0,
                                         int n_valid, float c) {
  float s[NT][4];
  uint32_t p[2 * NT];
  wg_scores<HD, NT>(s, dq, K + k0 * HD * sizeof(bf16));
  if (k0 + 8 * NT > n_valid) mask_keys<NT>(s, k0, n_valid);
  pack_p<NT>(p, s, mm, c);
  pv_issue<HD, NT>(o, p, V + k0 * HD * sizeof(bf16));
  wgmma_wait<0>();
  fence_regs(o);
}
}  // namespace fused

// Work items u = blockIdx.x, blockIdx.x + gridDim.x, ... < n_items; item u
// is head u / split. Resident (streamed = 0): share u % split of the head's
// 64-row query blocks. Streamed: query rows [192 (u % split), + 192), 64
// for each warpgroup.
template <int HD>
__global__ void __launch_bounds__(fused::THREADS, 1)
fused_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       bf16* __restrict__ out, int N, int n_valid,
                       int n_items, int split, int streamed, float c) {
  using namespace fused;
  constexpr int ROW = HD * sizeof(bf16);
  __shared__ __align__(8) uint64_t bars[2 * RING + WGS];
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* const base = align1024(smem_raw);
  uint64_t* const full = bars;
  uint64_t* const empty = bars + RING;
  uint64_t* const qbar = bars + 2 * RING;  // [WGS]: a Q block landed
  const int rows = (n_valid + 15) / 16 * 16;  // keys the passes read
  const int chunks = (n_valid + CHUNK - 1) / CHUNK;
  const int stages = streamed ? RING : 2;
  // bytes of one stage's K (V follows it); the Q blocks follow the stages
  const uint32_t kv_bytes = (streamed ? CHUNK : rows) * ROW;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    for (int w = 0; w < WGS; ++w) mbar_init(&qbar[w], 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == WARPS) {  // producer: one lane issues every copy
    if (lane == 0) {
      uint32_t it = 0;  // stage uses so far
      for (int u = blockIdx.x; u < n_items; u += gridDim.x) {
        const int head = u / split;
        for (int pass = 0; pass < (streamed ? 2 : 1); ++pass) {
          for (int ch = 0; ch < (streamed ? chunks : 1); ++ch, ++it) {
            const int s = it % stages;
            mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);  // round 0 passes
            unsigned char* st = base + 2 * s * kv_bytes;
            const int r0 = streamed ? ch * CHUNK : 0;
            const int nr = streamed ? CHUNK : rows;
            const bool with_v = !streamed || pass == 1;
            mbar_expect_tx(&full[s], with_v ? 2 * kv_bytes : kv_bytes);
            for (int r = 0; r < nr; r += BOX) {
              tma_load_3d(st + r * ROW, &kmap, &full[s], 0, r0 + r, head);
              if (with_v)
                tma_load_3d(st + kv_bytes + r * ROW, &vmap, &full[s], 0,
                            r0 + r, head);
            }
          }
        }
      }
    }
    return;
  }

  // Every consumer warp waits on every stage use before it arrives on its
  // "empty" barrier, also when it has no rows there: an arrival can then
  // never count towards an earlier use of the stage.
  const int wg = warp >> 2, wrow = (warp & 3) * 16;  // this warp's rows
  unsigned char* const qbuf = base + 2 * stages * kv_bytes + wg * 64 * ROW;
  uint32_t qph = 0;
  if (!streamed) {
    const int QB = (N + 63) / 64;  // 64-row query blocks of a head
    int pos = wg;                  // this warpgroup's next block in the
    int first = 0;                 // CTA's stream; the item's first one
    uint32_t it = 0;
    for (int u = blockIdx.x; u < n_items; u += gridDim.x, ++it) {
      const int head = u / split, part = u % split;
      const int b0 = part * QB / split, cnt = (part + 1) * QB / split - b0;
      const int s = it & 1;
      mbar_wait(&full[s], (it >> 1) & 1);
      const unsigned char* K = base + 2 * s * kv_bytes;
      const unsigned char* V = K + kv_bytes;
      bf16* const oh = out + (size_t)head * N * HD;
      for (; pos < first + cnt; pos += WGS) {
        const int r64 = (b0 + pos - first) * 64;
        const uint64_t dq =
            load_q_block<HD>(qbuf, &qmap, &qbar[wg], qph, r64, head);
        float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, mm[2];
        int k0 = 0;
        for (; k0 + 128 <= rows; k0 += 128)
          stats_chunk<HD, 16>(m, l, dq, K, k0, n_valid, c);
        for (; k0 < rows; k0 += 16)
          stats_chunk<HD, 2>(m, l, dq, K, k0, n_valid, c);
        normaliser(mm, m, l);
        float o[HD / 8][4] = {};
        for (k0 = 0; k0 + 64 <= rows; k0 += 64)
          pv_chunk<HD, 8>(o, mm, dq, K, V, k0, n_valid, c);
        for (; k0 < rows; k0 += 16)
          pv_chunk<HD, 2>(o, mm, dq, K, V, k0, n_valid, c);
        store_o<HD>(oh, HD, o, r64 + wrow, N);
      }
      first += cnt;
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    return;
  }

  uint32_t it = 0;
  for (int u = blockIdx.x; u < n_items; u += gridDim.x) {
    const int head = u / split;
    const int r64 = (u % split) * 64 * WGS + wg * 64;  // warpgroup's rows
    const bool active = r64 < N;
    uint64_t dq = 0;
    if (active) dq = load_q_block<HD>(qbuf, &qmap, &qbar[wg], qph, r64, head);
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, mm[2];
    for (int ch = 0; ch < chunks; ++ch, ++it) {  // pass 1: K chunks
      const int s = it % RING;
      mbar_wait(&full[s], (it / RING) & 1);
      if (active)
        stats_chunk<HD, 8>(m, l, dq, base + 2 * s * kv_bytes, 0,
                           n_valid - ch * CHUNK, c);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    normaliser(mm, m, l);
    float o[HD / 8][4] = {};
    for (int ch = 0; ch < chunks; ++ch, ++it) {  // pass 2: K and V chunks
      const int s = it % RING;
      mbar_wait(&full[s], (it / RING) & 1);
      const unsigned char* K = base + 2 * s * kv_bytes;
      if (active)
        pv_chunk<HD, 8>(o, mm, dq, K, K + kv_bytes, 0, n_valid - ch * CHUNK,
                        c);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (active) store_o<HD>(out + (size_t)head * N * HD, HD, o, r64 + wrow, N);
  }
}

// ---------------------------------------------------------------- B.7
namespace flash {
constexpr int BM = 128;       // query rows per CTA: two warpgroups of 64
constexpr int BN = 128;       // keys per tile
constexpr int STAGES = 4;     // K/V ring
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups

template <int HD>
struct Tiles {
  static constexpr uint32_t ROW = HD * sizeof(bf16);  // 128 or 64 bytes
  static constexpr uint32_t Q_BYTES = BM * ROW;
  static constexpr uint32_t KV_BYTES = BN * ROW;     // one K or V tile
  static constexpr size_t SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
};

template <int HD>
__device__ __forceinline__ void rescale(float (&o)[HD / 8][4],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[j][0] *= alpha[0];
    o[j][1] *= alpha[0];
    o[j][2] *= alpha[1];
    o[j][3] *= alpha[1];
  }
}
}  // namespace flash

// CTA b: head b / q_blocks, query rows 128 (b % q_blocks) ..
template <int HD>
__global__ void __launch_bounds__(flash::THREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       bf16* __restrict__ out, int N, int n_valid,
                       int q_blocks, float c) {
  using namespace flash;
  typedef Tiles<HD> T;
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* const Qs = align1024(smem_raw);
  unsigned char* const KV = Qs + T::Q_BYTES;  // stage s: K, then V
  uint64_t* const qfull = bars;
  uint64_t* const kfull = bars + 1;
  uint64_t* const vfull = bars + 1 + STAGES;
  uint64_t* const empty = bars + 1 + 2 * STAGES;
  const int bh = blockIdx.x / q_blocks, q0 = (blockIdx.x % q_blocks) * BM;
  const int n_tiles = (n_valid + BN - 1) / BN;  // later keys are all masked
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 8);  // the consumer warps
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // one if / else over the roles, so each warpgroup's register count holds
  // from its setmaxnreg to the end: the producer's registers go to the
  // consumers
  if (warp < 4) {  // producer warpgroup: one lane issues every copy
    setmaxnreg_dec<40>();
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(qfull, T::Q_BYTES);
      tma_load_3d(Qs, &qmap, qfull, 0, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);  // round 0 passes
        unsigned char* st = KV + 2 * s * T::KV_BYTES;
        mbar_expect_tx(&kfull[s], T::KV_BYTES);
        tma_load_3d(st, &kmap, &kfull[s], 0, j * BN, bh);
        mbar_expect_tx(&vfull[s], T::KV_BYTES);
        tma_load_3d(st + T::KV_BYTES, &vmap, &vfull[s], 0, j * BN, bh);
      }
    }
  } else {
    // consumer warpgroup cw: query rows q0 + 64 cw ..; named barrier 1 + cw
    // opens its turn at the tensor cores, which the other one passes on
    setmaxnreg_inc<232>();
    const int cw = (warp >> 2) - 1;
    const int mine = 1 + cw, other = 2 - cw;
    if (cw == 0) named_arrive(1, 256);  // warpgroup 0 takes the first turn
    const uint64_t dq = swz_desc(Qs + cw * 64 * T::ROW, T::ROW);
    auto ktile = [&](int j) { return KV + 2 * (j % STAGES) * T::KV_BYTES; };
    float o[HD / 8][4] = {}, s[BN / 8][4];
    uint32_t p[BN / 4];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float alpha[2] = {1.f, 1.f};
    mbar_wait(qfull, 0);

    // Each turn issues one S product and (from the second tile on) the
    // previous tile's P . V; both turn counts are n_tiles, and warpgroup 1
    // passes on all but its last, so every named barrier closes as often as
    // it opens.
    mbar_wait(&kfull[0], 0);
    named_sync(mine, 256);
    qk_issue<HD, BN / 8>(s, dq, ktile(0));
    if (cw == 0 || n_tiles > 1) named_arrive(other, 256);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_step<BN / 8>(s, m, l, alpha, 0, n_valid, c);
    pack_p<BN / 8>(p, s);
    for (int j = 1; j < n_tiles; ++j) {
      mbar_wait(&kfull[j % STAGES], (j / STAGES) & 1);
      named_sync(mine, 256);
      qk_issue<HD, BN / 8>(s, dq, ktile(j));
      rescale<HD>(o, alpha);
      mbar_wait(&vfull[(j - 1) % STAGES], ((j - 1) / STAGES) & 1);
      pv_issue<HD, BN / 8>(o, p, ktile(j - 1) + T::KV_BYTES);
      if (cw == 0 || j < n_tiles - 1) named_arrive(other, 256);
      wgmma_wait<1>();  // S of tile j landed; P . V of tile j - 1 may run on
      fence_regs(s);
      softmax_step<BN / 8>(s, m, l, alpha, j * BN, n_valid, c);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[(j - 1) % STAGES]);
      pack_p<BN / 8>(p, s);
    }
    mbar_wait(&vfull[(n_tiles - 1) % STAGES], ((n_tiles - 1) / STAGES) & 1);
    rescale<HD>(o, alpha);
    pv_issue<HD, BN / 8>(o, p, ktile(n_tiles - 1) + T::KV_BYTES);
    wgmma_wait<0>();
    fence_regs(o);

    // O / max(l, 1e-30) as bf16 pairs straight from the accumulators
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(quad_sum(l[r]), 1e-30f);
    rescale<HD>(o, inv);
    store_o<HD>(out + (size_t)bh * N * HD, HD, o,
                q0 + cw * 64 + (warp & 3) * 16, N);
  }
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

constexpr CUtensorMapSwizzle swizzle_of(int hd) {
  return hd == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

template <int HD>
cudaError_t launch_fused(const bf16* q, const bf16* k, const bf16* v,
                         bf16* out, int BH, int N, int n_valid, float c,
                         cudaStream_t st) {
  using namespace fused;
  CUtensorMap qm, km, vm;
  if (!tensor_map_3d(&qm, q, HD, N, BH, HD, 64, swizzle_of(HD)) ||
      !tensor_map_3d(&km, k, HD, N, BH, HD, BOX, swizzle_of(HD)) ||
      !tensor_map_3d(&vm, v, HD, N, BH, HD, BOX, swizzle_of(HD)))
    return cudaErrorInvalidValue;
  const int rows = (n_valid + 15) / 16 * 16, sms = sm_count();
  const bool streamed = resident_smem(rows, HD) > SMEM_MAX;
  const size_t smem = streamed ? streamed_smem(HD) : resident_smem(rows, HD);
  int split;
  if (streamed) {
    split = (N + 64 * WGS - 1) / (64 * WGS);  // query blocks per head
  } else {  // with fewer heads than SMs a head's blocks go to several CTAs
    const int blocks = (N + 63) / 64;
    split = BH >= sms ? 1 : std::min(blocks, (sms + BH - 1) / BH);
  }
  if ((long long)BH * split > INT_MAX) return cudaErrorInvalidValue;
  const int items = BH * split;
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_attention_kernel<HD><<<std::min(items, sms), THREADS, smem, st>>>(
      qm, km, vm, out, N, n_valid, items, split, streamed ? 1 : 0, c);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_flash(const bf16* q, const bf16* k, const bf16* v,
                         bf16* out, int BH, int N, int n_valid, float c,
                         cudaStream_t st) {
  using namespace flash;
  typedef Tiles<HD> T;
  CUtensorMap qm, km, vm;
  if (!tensor_map_3d(&qm, q, HD, N, BH, HD, BM, swizzle_of(HD)) ||
      !tensor_map_3d(&km, k, HD, N, BH, HD, BN, swizzle_of(HD)) ||
      !tensor_map_3d(&vm, v, HD, N, BH, HD, BN, swizzle_of(HD)))
    return cudaErrorInvalidValue;
  const int q_blocks = (N + BM - 1) / BM;
  if ((long long)q_blocks * BH > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::SMEM);
  if (err != cudaSuccess) return err;
  flash_attention_kernel<HD><<<q_blocks * BH, THREADS, T::SMEM, st>>>(
      qm, km, vm, out, N, n_valid, q_blocks, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, k, v, out [BH, N, hd] bf16 contiguous; hd 32 or 64; 0 < n_valid <= N;
// flash = 0 runs the two-pass kernel (B.6), 1 the online-softmax kernel
// (B.7). Returns the CUDA error (cudaErrorInvalidValue also when the driver
// refuses a TMA map).
int attention_forward(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                      int BH, int N, int hd, int n_valid, float scale,
                      int flash, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (BH == 0 || N == 0) return 0;
  if (n_valid <= 0 || n_valid > N || (hd != 64 && hd != 32))
    return (int)cudaErrorInvalidValue;
  const float c = scale * kLog2e;
  cudaError_t err;
  if (flash)
    err = hd == 64 ? launch_flash<64>(q, k, v, out, BH, N, n_valid, c, s)
                   : launch_flash<32>(q, k, v, out, BH, N, n_valid, c, s);
  else
    err = hd == 64 ? launch_fused<64>(q, k, v, out, BH, N, n_valid, c, s)
                   : launch_fused<32>(q, k, v, out, BH, N, n_valid, c, s);
  return (int)err;
}

}  // extern "C"
