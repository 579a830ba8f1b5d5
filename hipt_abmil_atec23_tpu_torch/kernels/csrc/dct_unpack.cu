// Sparse-DCT pack v3 -> dequantized AC coefficients, for Hopper (sm_90a).
//
// Replaces the TPU kernel hipt_abmil_atec23_tpu/ops/jpegdct.py
// _unpack_kernel (launcher _unpack_pallas). The TPU kernel keeps every
// array lane-resident: Mosaic cannot reshape across lanes, so its caller
// pre-shapes each byte stream to f32 [NG, Q, R] and the kernel places the
// k-th stream value at the k-th marked coefficient through one-hot matrix
// products on the MXU, with prefix sums as log2 shifted adds. None of that
// carries over. Here a warp owns one 16-block group and reads the raw pack
// bytes:
//
//   for each block b of the group (in order):
//     cnt = the block's shipped bitmap-byte count (4-bit nibble of bmc);
//     lane l holds coefficients k = l and k = l + 32: its bit is bit k & 7
//     of shipped byte k >> 3 (0 past cnt);
//     __ballot_sync + __popc over the warp give each nonzero coefficient
//     its value slot (the group's running slot count + the set bits below
//     it), and the nibble at that slot is its value in [-8, 7];
//     a second ballot over (bit && nibble == -8) gives each escape its
//     slot in the group's escape bytes, whose int8 replaces the -8;
//     the value times q[k] is stored as f32, a warp writing 2 x 128
//     contiguous bytes per block.
//
// The DC column (bit 0 is never set) and padded blocks past the region's
// block count come out 0. The DC chain and the explicit-index escape
// scatters run after this kernel in plain PyTorch, as they run in XLA in
// the JAX package. The output is integers times the quant table, so the
// kernel equals its plain PyTorch version bit for bit.
//
// Bound on this card: device memory. A batch of two 4096^2 regions writes
// 201 MB of f32 coefficients (Y 2 x 262144 blocks, Cb and Cr 2 x 65536
// blocks each, 256 B per block) and reads a pack of some tens of MB; the
// arithmetic is a few dozen integer operations per coefficient. Stores
// are coalesced and each pack byte is read by one warp only.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kG = 16;       // blocks per group (ops/jpegdct._G)
constexpr int kWarps = 8;    // groups per CTA
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int nibble_at(const uint8_t* vn, int s) {
  const int v = (vn[s >> 1] >> ((s & 1) * 4)) & 0xF;
  return v > 7 ? v - 16 : v;  // two's-complement 4-bit
}

__global__ void __launch_bounds__(kWarps * 32)
unpack_kernel(const uint8_t* __restrict__ bmc, const uint8_t* __restrict__ bmb,
              const uint8_t* __restrict__ valn,
              const int8_t* __restrict__ esc8, const float* __restrict__ q,
              float* __restrict__ out, int64_t n_groups, int ng, int bl,
              int capbm, int capg, int capge) {
  const int lane = threadIdx.x & 31;
  const int64_t g = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (g >= n_groups) return;  // whole warps exit together
  const int64_t r = g / ng;
  const int gg = int(g - r * ng);
  const uint8_t* cnts = bmc + r * ((bl + 1) / 2);
  const uint8_t* bm = bmb + g * capbm;
  const uint8_t* vn = valn + g * (capg / 2);
  const int8_t* es = esc8 + g * capge;
  float* o = out + g * (kG * 64);
  const float q0 = q[lane], q1 = q[lane + 32];
  const unsigned below = (1u << lane) - 1u;
  const int i0 = lane >> 3, i1 = 4 + (lane >> 3), sh = lane & 7;
  int boff = 0, slots = 0, escs = 0;
  for (int b = 0; b < kG; ++b) {
    const int bi = gg * kG + b;
    const int cnt = bi < bl ? (cnts[bi >> 1] >> ((bi & 1) * 4)) & 0xF : 0;
    const int bit0 =
        (i0 < cnt && boff + i0 < capbm) ? (bm[boff + i0] >> sh) & 1 : 0;
    const int bit1 =
        (i1 < cnt && boff + i1 < capbm) ? (bm[boff + i1] >> sh) & 1 : 0;
    const unsigned m0 = __ballot_sync(kFull, bit0);
    const unsigned m1 = __ballot_sync(kFull, bit1);
    const int s0 = slots + __popc(m0 & below);
    const int s1 = slots + __popc(m0) + __popc(m1 & below);
    const int n0 = (bit0 && s0 < capg) ? nibble_at(vn, s0) : 0;
    const int n1 = (bit1 && s1 < capg) ? nibble_at(vn, s1) : 0;
    const int e0 = n0 == -8, e1 = n1 == -8;  // only a set bit reads -8
    const unsigned em0 = __ballot_sync(kFull, e0);
    const unsigned em1 = __ballot_sync(kFull, e1);
    const int t0 = escs + __popc(em0 & below);
    const int t1 = escs + __popc(em0) + __popc(em1 & below);
    const int v0 = e0 ? (t0 < capge ? int(es[t0]) : 0) : n0;
    const int v1 = e1 ? (t1 < capge ? int(es[t1]) : 0) : n1;
    o[b * 64 + lane] = float(v0) * q0;
    o[b * 64 + 32 + lane] = float(v1) * q1;
    boff += cnt;
    slots += __popc(m0) + __popc(m1);
    escs += __popc(em0) + __popc(em1);
  }
}

}  // namespace

extern "C" {

const char* dct_unpack_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One component of n regions, n_groups = n * ng groups of 16 blocks:
//   bmc  uint8 [n, (bl + 1) / 2]  4-bit per-block bitmap byte counts
//   bmb  uint8 [n_groups, capbm]  shipped bitmap prefix bytes
//   valn uint8 [n_groups, capg/2] nibble-packed values (capg even)
//   esc8 int8  [n_groups, capge]  escape bytes
//   q    f32   [64]               quant table, natural order
//   out  f32   [n_groups, 1024]   dequantized AC coefficients
// Launches on `stream`; returns cudaGetLastError().
int dct_unpack_launch(const uint8_t* bmc, const uint8_t* bmb,
                      const uint8_t* valn, const int8_t* esc8, const float* q,
                      float* out, int64_t n_groups, int ng, int bl, int capbm,
                      int capg, int capge, void* stream) {
  if (n_groups <= 0 || ng <= 0 || bl <= 0 || capbm < 0 || capg < 0 ||
      capg % 2 || capge < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n_groups + kWarps - 1) / kWarps;
  unpack_kernel<<<dim3(unsigned(blocks)), kWarps * 32, 0,
                  reinterpret_cast<cudaStream_t>(stream)>>>(
      bmc, bmb, valn, esc8, q, out, n_groups, ng, bl, capbm, capg, capge);
  return (int)cudaGetLastError();
}

}  // extern "C"
