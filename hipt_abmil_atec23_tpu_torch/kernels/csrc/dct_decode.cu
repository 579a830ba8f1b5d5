// Sparse-DCT pack v3 -> cropped, white-masked uint8 YCbCr planes, the whole
// decode in two launches (a DC pre-pass and the decode), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel hipt_abmil_atec23_tpu/ops/jpegdct.py
// _unpack_kernel (launcher _unpack_pallas) together with the XLA program
// that XLA fuses around it on the TPU (the DC chain, the |v| > 127
// explicit escapes, dequantization, the 8x8 IDCT, the crop and the white
// mask of dct_regions_to_planes). The TPU kernel keeps every array
// lane-resident and places stream values through one-hot matrix products
// on the MXU; eager PyTorch around a kernel that did only that wrote the
// f32 coefficients (201 MB per batch of two 4096^2 regions), then f32 IDCT
// intermediates, to device memory. Here the pack is read, the planes are
// written, and in between only each block's DC (4 bytes) goes through
// device memory.
//
// Both kernels give one CTA to one 8-pixel band of one component of one
// region: block row r of its block grid (bw blocks).
//
//   dc_kernel: d[c] = dc8[r, c], overridden by the `desc` entries of the
//     row; d[0] becomes the chained row start sum_{r' <= r} d[r', 0] (a
//     strided sum down column 0 plus the desc entries of column 0 above
//     the row), and an inclusive scan along the row gives every block's
//     DC. It also finds the row's range of aidx entries. Its chain of
//     searches and barriers runs in small CTAs, 16 to an SM.
//   decode_kernel, AC: each warp takes one 16-block group that overlaps
//     the row (a group is 16 raster-consecutive blocks of the flattened
//     grid, so when bw % 16 != 0 a group straddles two rows and both
//     rows' CTAs decode it, each its own blocks). The group's bitmap
//     bytes and nibbles come to shared memory by cp.async, the next
//     group's while this one decodes. Lane b < 16 builds block b's 64-bit
//     nonzero mask from its shipped bitmap bytes; prefix sums over the
//     lanes give each block its first bitmap byte and first value slot.
//     Per 16 nibble slots, a word-wide compare marks the -8 nibbles and a
//     prefix sum counts the marks before them, which gives any escape its
//     byte. Lanes 2b and 2b + 1 then place block b's values times the
//     quant table in the warp's tile, every other set bit each. The
//     |v| > 127 explicit escapes of the group overwrite their
//     coefficients (pre-dequantized), and the DC goes into coefficient 0.
//   IDCT: s = M^T F M + 128 in f32 in the tile, each 8-point transform by
//     its even and odd halves (M[u][7 - n] = (-1)^u M[u][n]), over only
//     the block's rows that can be nonzero (its shipped bitmap byte count,
//     raised by its explicit escapes; the rest are zero): pass 1 a (block,
//     row) task a lane from a table, pass 2 rows y and 7 - y of a block a
//     lane, rounded half to even (as torch.round) and clamped to 0..255
//     into the band, a shared-memory copy of the row's 8 pixel rows.
//   Out: the band's rows and columns inside the crop window (luma offset
//     off, chroma off / 2) are written with 16-byte stores, white (Y 255,
//     Cb = Cr 128) past the valid extent (chroma past (valid + 1) / 2).
//
// The explicit escape streams (aidx by coefficient, didx by block) are
// found by binary search: both packers (the native reader's
// pack_dct2_component and slideio/synthetic.pack_dct_v3) write the valid
// entries in ascending order with the idx = -1 pads after them, and the
// search reads an index as unsigned so the pads sort last
// (tests/test_torch_jpegdct.py holds both packers to that order).
//
// An optional tap writes each block's dequantized coefficients (after the
// escapes and the DC, before the IDCT) as ops/jpegdct._unpack_component
// returns them; only checks pass it.
//
// Numerics: the coefficients are integers times the table, bit for bit
// the plain version's. The IDCT sums in another order than the plain
// version's matrix products, so a sample whose f32 value lies within
// rounding of a .5 may come out 1 LSB apart.
//
// Bound on this card: a batch of two 4096^2 regions reads a pack of ~15
// MB and writes 50 MB of planes (0.020 ms at 3.35 TB/s); the IDCT's f32
// operations over the rows that ship are fewer than that at 67 TFLOP/s.
// What holds the kernel back is instruction issue, chiefly the placement
// of each shipped value and the transform of each shipped row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kG = 16;                    // blocks per group (ops/jpegdct._G)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kDcWarps = 4;               // the DC pre-pass's CTA
constexpr int kDcThreads = kDcWarps * 32;
constexpr int kStride = 72;               // floats per block in the tile
constexpr int kTileFloats = kG * kStride; // one warp's tile
constexpr unsigned kFull = 0xffffffffu;

struct Comp {
  const int8_t* dc8;    // [n, bh * bw]
  const uint8_t* bmc;   // [n, (bl + 1) / 2]
  const uint8_t* bmb;   // [n * ng, capbm]
  const uint8_t* valn;  // [n * ng, capg / 2]
  const int8_t* esc8;   // [n * ng, capge]
  const int32_t* aidx;  // [n, cap_a]
  const int16_t* aval;  // [n, cap_a]
  const int32_t* didx;  // [n, cap_d]
  const int16_t* dval;  // [n, cap_d]
  uint8_t* out;         // [n, out_h, out_w]
  float* tap;           // [n, bl, 64] or null
  int* dc;              // [n, bl] the blocks' DC, from the pre-pass
  int bh, bw, capbm, capg, capge, cap_a, cap_d;
  int out_h, out_w, denom, fill;
};

struct Params {
  Comp c[3];
  float m[64];             // the IDCT basis, M[u * 8 + x]
  const int32_t* qt;       // [3, 64] natural order
  const int32_t* valid;    // [n, 2] (valid_w, valid_h)
  const int32_t* off;      // [n, 2] (dx, dy) luma crop offsets, or null
  int* rng;                // [n * rows, 2] each row's aidx range, pre-pass
  int rows;                // block rows per region over Y, Cb, Cr
  int max_bw, max_stage;   // the widest row and stream stage of the three
};

// First j in [lo, hi) with a[j] >= key (hi if none), -1 pads reading as
// the largest; a[lo, hi) ascending. The whole warp searches together, 32
// probes a round, and every lane gets the answer.
__device__ __forceinline__ int warp_lower_bound(const int32_t* a, int lo,
                                                int hi, unsigned key,
                                                int lane) {
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int pos = lo + lane * step;
    const bool below = pos < hi && unsigned(a[pos]) < key;
    const int k = __popc(__ballot_sync(kFull, below));  // probes below key
    if (k == 0) return lo;
    lo = lo + (k - 1) * step + 1;
    hi = min(lo - 1 + step, hi);
  }
  const bool below = lo + lane < hi && unsigned(a[lo + lane]) < key;
  return lo + __popc(__ballot_sync(kFull, below));
}

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// n bytes from device memory to shared memory by the whole warp: cp.async
// 4 bytes at a time where both sides allow it (the copy then completes at
// the warp's next cp.async.wait_group), plain loads otherwise.
__device__ __forceinline__ void fetch(uint8_t* dst, const uint8_t* src,
                                      int n, int lane) {
  if (((reinterpret_cast<uintptr_t>(src) | n) & 3) == 0) {
    const unsigned d = unsigned(__cvta_generic_to_shared(dst));
    for (int i = lane; i < n / 4; i += 32)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       d + 4 * i),
                   "l"(src + 4 * i));
  } else {
    for (int i = lane; i < n; i += 32) dst[i] = src[i];
  }
}

__device__ __forceinline__ void fetch_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for all but the newest committed fetch.
__device__ __forceinline__ void fetch_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Bit 4i + 3 set where nibble i of w is 8, the -8 that marks an escape.
__device__ __forceinline__ unsigned long long escape_marks(
    unsigned long long w) {
  const unsigned long long t = w ^ 0x8888888888888888ull;  // 8 -> 0
  const unsigned long long lo = 0x7777777777777777ull;
  return ~(((t & lo) + lo) | t | lo);  // bit 3 of each zero nibble
}

// Inclusive sum over the lanes below and at this one.
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// One warp's stage in shared memory for the groups of one component: two
// buffers that the group's bitmap bytes and nibbles (with 8 bytes of
// slack: the escape marks read whole 8-byte words) are fetched into in
// turn, the next group's while this one decodes; then per 16 nibble
// slots the escape marks and the escapes before them, and the IDCT's
// (block, row) tasks.
struct Stage {
  int vn, buf, marks, before, tasks, bytes;
  __host__ __device__ Stage(int capbm, int capg) {
    const int chunks = (capg + 15) / 16;
    vn = align16(capbm);
    buf = vn + align16(capg / 2 + 8);
    marks = 2 * buf;
    before = marks + chunks * 8;
    tasks = before + chunks * 4;
    bytes = align16(tasks + kG * 8);
  }
};

// Shared memory of one decode CTA: the warps' stages and coefficient
// tiles, the band of 8 pixel rows.
struct Layout {
  int stage, tiles, band, total;
  __host__ __device__ Layout(int bw, int stage_bytes) {
    stage = align16(stage_bytes);
    tiles = kWarps * stage;
    band = tiles + kWarps * kTileFloats * 4;
    total = band + bw * 64;
  }
};

__device__ __forceinline__ void fetch_group(const Comp& c, const Stage& L,
                                            int64_t g, uint8_t* buf,
                                            int lane) {
  fetch(buf, c.bmb + g * c.capbm, c.capbm, lane);
  fetch(buf + L.vn, c.valn + g * (c.capg / 2), c.capg / 2, lane);
}

// Group gg of a component, its streams fetched to buf: its 16 blocks'
// dequantized values into the warp's tile, zero where nothing ships.
// Blocks outside [b0, b1) (a straddling group's other row) are skipped.
// cbyte: in lane i < 8, byte i of the group's bitmap byte counts. Returns,
// in lane b < 16, block b's count of shipped bitmap bytes: the rows of its
// 8x8 block that may hold a nonzero.
//
// Lane b < 16 builds block b's 64-bit nonzero mask from its bitmap
// bytes, whose offsets and value slots are prefix sums over the lanes.
// Per 16 nibble slots, the -8 marks and the count of marks before them
// give any slot's escape byte. Then lanes 2b and 2b + 1 place block b's
// values, every other set bit each.
__device__ __forceinline__ int decode_group(const Comp& c, const Stage& L,
                                            int64_t g, int gg, int bl,
                                            int b0, int b1, int cbyte,
                                            const uint8_t* buf,
                                            uint8_t* st, float* tile,
                                            const float* qs, int lane) {
  const uint8_t* bm = buf;
  const uint8_t* vn = buf + L.vn;
  const int8_t* es = c.esc8 + g * c.capge;
  unsigned long long* marks =
      reinterpret_cast<unsigned long long*>(st + L.marks);
  int* before = reinterpret_cast<int*>(st + L.before);
  const int byte = __shfl_sync(kFull, cbyte, (lane >> 1) & 7);
  const int cnt = (lane < kG && gg * kG + lane < bl)
                      ? (byte >> ((lane & 1) * 4)) & 0xF : 0;
  const int boff = warp_scan(cnt, lane) - cnt;
  unsigned long long m = 0;
  for (int i = 0; i < cnt && boff + i < c.capbm; ++i)
    m |= (unsigned long long)bm[boff + i] << (8 * i);
  const int nnz = __popcll(m);
  const int slot0 = warp_scan(nnz, lane) - nnz;
  const int chunks = (c.capg + 15) / 16;
  for (int ch0 = 0, run = 0; ch0 < chunks; ch0 += 32) {
    const int ch = ch0 + lane;
    unsigned long long mk = 0;
    if (ch < chunks) {
      mk = escape_marks(*reinterpret_cast<const unsigned long long*>(
          vn + ch * 8));
      marks[ch] = mk;
    }
    const int k = __popcll(mk), x = warp_scan(k, lane);
    if (ch < chunks) before[ch] = run + x - k;
    run += __shfl_sync(kFull, x, 31);
  }
  const int b = lane >> 1, par = lane & 1;
  const bool mine = b >= b0 && b < b1;
  if (mine) {
    float4* z = reinterpret_cast<float4*>(tile + b * kStride + par * 32);
#pragma unroll
    for (int i = 0; i < 8; ++i) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncwarp();
  unsigned long long mm = __shfl_sync(kFull, m, b);
  int s = __shfl_sync(kFull, slot0, b) + par;
  if (!mine) mm = 0;
  if (par) mm &= mm - 1;
  while (mm) {
    const int k = __ffsll(mm) - 1;
    mm &= mm - 1;
    mm &= mm - 1;
    int v = 0;
    if (s < c.capg) {
      v = (vn[s >> 1] >> ((s & 1) * 4)) & 0xF;
      v = v > 7 ? v - 16 : v;  // two's-complement 4-bit
      if (v == -8) {
        const int ch = s >> 4;
        const int t = before[ch] + __popcll(
            marks[ch] & ((1ull << (4 * (s & 15))) - 1));
        v = t < c.capge ? int(es[t]) : 0;
      }
    }
    tile[b * kStride + k] = float(v) * qs[k];
    s += 2;
  }
  return cnt;
}

// Four values in 0..255 as the bytes of a word, the first lowest.
__device__ __forceinline__ unsigned pack4(const unsigned* q) {
  return __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                     __byte_perm(q[2], q[3], 0x0040), 0x5410);
}

// The 8-point IDCT x[n] = sum_u X[u] M[u][n] by its even / odd halves
// (M[u][7 - n] = (-1)^u M[u][n]): x[n] = e[n] + o[n], x[7 - n] = e[n] -
// o[n] for n < 4, with e over the even u and o over the odd.
__device__ __forceinline__ void idct8(const float* m, const float* X,
                                      float* x) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float e = X[0] * m[n], o = X[1] * m[8 + n];
    e = fmaf(X[2], m[16 + n], e);
    o = fmaf(X[3], m[24 + n], o);
    e = fmaf(X[4], m[32 + n], e);
    o = fmaf(X[5], m[40 + n], o);
    e = fmaf(X[6], m[48 + n], e);
    o = fmaf(X[7], m[56 + n], o);
    x[n] = e + o;
    x[7 - n] = e - o;
  }
}

// Where CTA blockIdx.x of either kernel works: (region, component, block
// row).
__device__ __forceinline__ int locate(const Params& p, int64_t& region,
                                      int& row) {
  region = blockIdx.x / p.rows;
  row = blockIdx.x - int(region) * p.rows;
  int ci = 0;
  if (row >= p.c[0].bh) {
    row -= p.c[0].bh;
    ci = 1 + (row >= p.c[1].bh);
    if (ci == 2) row -= p.c[1].bh;
  }
  return ci;
}

// The pre-pass, one CTA per block row: the row's DC (dc8 with its desc
// overrides, the row start chained down column 0, an inclusive scan along
// the row) to c.dc, and the row's range of aidx entries to p.rng. Its
// latency chain (searches, three barriers) runs in small CTAs that the
// card holds 16 to an SM, not in the decode's.
__global__ void __launch_bounds__(kDcThreads) dc_kernel(const Params p) {
  extern __shared__ int dcrow[];
  __shared__ int wsum[kDcWarps];
  __shared__ int rng[3];  // the row's desc end, aidx begin and end
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int64_t region;
  int row;
  const Comp& c = p.c[locate(p, region, row)];
  const int bw = c.bw, bl = c.bh * bw;
  const int first = row * bw;  // the row's first block
  const int32_t* aidx = c.aidx + region * c.cap_a;
  const int32_t* didx = c.didx + region * c.cap_d;
  const int16_t* dval = c.dval + region * c.cap_d;
  const int8_t* dc8 = c.dc8 + region * bl;
  for (int i = tid; i < bw; i += kDcThreads) dcrow[i] = dc8[first + i];
  int s0 = 0;
  for (int r = tid; r <= row; r += kDcThreads) s0 += dc8[r * bw];
  if (warp == 0)
    rng[0] = warp_lower_bound(didx, 0, c.cap_d, unsigned(first + bw), lane);
  if (warp == 1)
    rng[1] = warp_lower_bound(aidx, 0, c.cap_a, unsigned(first) * 64, lane);
  if (warp == 2)
    rng[2] = warp_lower_bound(aidx, 0, c.cap_a,
                              unsigned(first + bw) * 64, lane);
  __syncthreads();
  for (int j = tid; j < rng[0]; j += kDcThreads) {
    const int b = didx[j], v = dval[j];
    if (b % bw == 0) s0 += v - dc8[b];
    if (b >= first) dcrow[b - first] = v;
  }
  for (int o = 16; o; o >>= 1) s0 += __shfl_xor_sync(kFull, s0, o);
  if (lane == 0) wsum[warp] = s0;
  __syncthreads();
  if (tid == 0) {
    int t = 0;
    for (int w = 0; w < kDcWarps; ++w) t += wsum[w];
    dcrow[0] = t;
    p.rng[blockIdx.x * 2] = rng[1];
    p.rng[blockIdx.x * 2 + 1] = rng[2];
  }
  __syncthreads();
  const int per = (bw + kDcThreads - 1) / kDcThreads;
  const int lo = min(tid * per, bw), hi = min(lo + per, bw);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += dcrow[i];
  const int x = warp_scan(sum, lane);
  if (lane == 31) wsum[warp] = x;  // tid 0 read the sums before the sync
  __syncthreads();
  int run = x - sum;
  for (int w = 0; w < warp; ++w) run += wsum[w];
  for (int i = lo; i < hi; ++i) {
    run += dcrow[i];
    dcrow[i] = run;
  }
  __syncthreads();
  for (int i = tid; i < bw; i += kDcThreads)
    c.dc[region * bl + first + i] = dcrow[i];
}

__global__ void __launch_bounds__(kThreads, 3)
decode_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int nrows[kWarps][kG];
  __shared__ float qs[64];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int64_t region;
  int row;
  const int ci = locate(p, region, row);
  const Comp& c = p.c[ci];
  const int bw = c.bw, bl = c.bh * bw, ng = (bl + kG - 1) / kG;
  const int first = row * bw;  // the row's first block
  const Layout lay(p.max_bw, p.max_stage);
  uint8_t* st = smem + warp * lay.stage;
  float* tile =
      reinterpret_cast<float*>(smem + lay.tiles) + warp * kTileFloats;
  uint8_t* band = smem + lay.band;
  const int W = bw * 8;
  const int32_t* aidx = c.aidx + region * c.cap_a;
  const int16_t* aval = c.aval + region * c.cap_a;
  const int* dc = c.dc + region * bl;
  if (tid < 64) qs[tid] = float(p.qt[ci * 64 + tid]);
  // each warp's first group of the row starts loading now
  const int gfirst = first / kG + warp, glast = (first + bw - 1) / kG;
  const Stage L(c.capbm, c.capg);
  const uint8_t* bmc = c.bmc + region * ((bl + 1) / 2);
  const int nbmc = (bl + 1) / 2;
  if (gfirst <= glast) fetch_group(c, L, region * ng + gfirst, st, lane);
  fetch_commit();
  int cbyte = (lane < kG / 2 && gfirst * 8 + lane < nbmc)
                  ? bmc[gfirst * 8 + lane] : 0;
  // lane b < 16: block b's DC (the row's blocks only)
  auto dc_of = [&](int gg) {
    const int bi = gg * kG + lane;
    return (lane < kG && bi >= first && bi < first + bw) ? dc[bi] : 0;
  };
  int dcv = gfirst <= glast ? dc_of(gfirst) : 0;
  const int ja_row = p.rng[blockIdx.x * 2], jb_row = p.rng[blockIdx.x * 2 + 1];
  __syncthreads();  // qs

  // ---- AC groups overlapping the row, one warp each: values, escapes,
  // DC, tap, IDCT into the band
  int* rows = nrows[warp];
  uint8_t* tasks = st + L.tasks;
  float my[8];  // M[u][y] for this lane's output rows y and 7 - y
#pragma unroll
  for (int u = 0; u < 8; ++u) my[u] = p.m[u * 8 + (lane & 3)];
  for (int gg = gfirst, cur = 0; gg <= glast; gg += kWarps, cur ^= 1) {
    // the next group's streams and counts load while this one decodes
    const int gn = gg + kWarps;
    if (gn <= glast)
      fetch_group(c, L, region * ng + gn, st + (cur ^ 1) * L.buf, lane);
    fetch_commit();
    const int next_cbyte = (gn <= glast && lane < kG / 2 &&
                            gn * 8 + lane < nbmc) ? bmc[gn * 8 + lane] : 0;
    const int next_dcv = gn <= glast ? dc_of(gn) : 0;
    fetch_wait_prior();
    __syncwarp();
    const int b0 = max(first - gg * kG, 0);           // the row's blocks
    const int b1 = min(first + bw - gg * kG, kG);     // of this group
    const int cnt = decode_group(c, L, region * ng + gg, gg, bl, b0, b1,
                                 cbyte, st + cur * L.buf, st, tile, qs,
                                 lane);
    cbyte = next_cbyte;
    const int dcb = dcv;
    dcv = next_dcv;
    // row 0 holds the DC; blocks of the other row get no IDCT task
    if (lane < kG) rows[lane] = lane >= b0 && lane < b1 ? max(cnt, 1) : 0;
    __syncwarp();
    if (ja_row < jb_row) {  // the row's |v| > 127 escapes in this group
      const int lo = gg * kG * 64;
      const int ja = warp_lower_bound(aidx, ja_row, jb_row, unsigned(lo),
                                      lane);
      const int jb = warp_lower_bound(aidx, ja, jb_row,
                                      unsigned(lo + kG * 64), lane);
      for (int j = ja + lane; j < jb; j += 32) {
        const int a = aidx[j] - lo;
        tile[(a >> 6) * kStride + (a & 63)] = float(aval[j]) * qs[a & 63];
        atomicMax(&rows[a >> 6], ((a & 63) >> 3) + 1);
      }
      __syncwarp();
    }
    if (lane >= b0 && lane < b1) tile[lane * kStride] = float(dcb) * qs[0];
    __syncwarp();
    if (c.tap) {
      for (int b = b0; b < b1; ++b) {
        float* t = c.tap + ((region * bl) + gg * kG + b) * 64;
        t[lane] = tile[b * kStride + lane];
        t[lane + 32] = tile[b * kStride + 32 + lane];
      }
    }
    // pass 1 over the rows that may be nonzero (the rest stay zero and
    // out of both passes): T[u][.] = IDCT of F[u][.], one (block, u) task
    // a lane from a table the lanes of the blocks fill
    const int nr = lane < kG ? rows[lane] : 0;
    const int rend = warp_scan(nr, lane);
    for (int u = 0; u < nr; ++u) tasks[rend - nr + u] = (lane << 3) | u;
    const int ntask = __shfl_sync(kFull, rend, kG - 1);
    __syncwarp();
    for (int i = lane; i < ntask; i += 32) {
      float4* f = reinterpret_cast<float4*>(
          tile + (tasks[i] >> 3) * kStride + (tasks[i] & 7) * 8);
      const float4 a = f[0], e = f[1];
      const float v[8] = {a.x, a.y, a.z, a.w, e.x, e.y, e.z, e.w};
      float t[8];
      idct8(p.m, v, t);
      f[0] = make_float4(t[0], t[1], t[2], t[3]);
      f[1] = make_float4(t[4], t[5], t[6], t[7]);
    }
    __syncwarp();
    // pass 2: rows y and 7 - y of block b, s[y][.] = sum_u M[u][y] T[u][.]
    // + 128 by the even / odd halves over u, rounded half to even,
    // clamped, 8 bytes each into the band
    for (int task = lane; task < kG * 4; task += 32) {
      const int b = task >> 2, y = task & 3, nu = rows[b];
      if (nu == 0) continue;
      const float4* f = reinterpret_cast<const float4*>(tile + b * kStride);
      float e[8], o[8];  // the level shift rides in e
#pragma unroll
      for (int x = 0; x < 8; ++x) o[x] = 0.0f;
      {
        const float4 a = f[0], h = f[1];
        const float t0[8] = {a.x, a.y, a.z, a.w, h.x, h.y, h.z, h.w};
#pragma unroll
        for (int x = 0; x < 8; ++x) e[x] = fmaf(t0[x], my[0], 128.0f);
      }
#pragma unroll
      for (int u = 1; u < 8; ++u) {
        if (u < nu) {
          const float4 a = f[2 * u], h = f[2 * u + 1];
          const float tu[8] = {a.x, a.y, a.z, a.w, h.x, h.y, h.z, h.w};
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            if (u & 1)
              o[x] = fmaf(tu[x], my[u], o[x]);
            else
              e[x] = fmaf(tu[x], my[u], e[x]);
          }
        }
      }
      unsigned qy[8], q7[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        qy[x] = min(__float2uint_rn(e[x] + o[x]), 255u);
        q7[x] = min(__float2uint_rn(e[x] - o[x]), 255u);
      }
      uint8_t* dst = band + (gg * kG + b - first) * 8;
      *reinterpret_cast<uint2*>(dst + y * W) =
          make_uint2(pack4(qy), pack4(qy + 4));
      *reinterpret_cast<uint2*>(dst + (7 - y) * W) =
          make_uint2(pack4(q7), pack4(q7 + 4));
    }
    __syncwarp();  // the tile and buffer are rewritten by the next group
  }
  __syncthreads();

  // ---- the band's rows inside the crop window, white past the extent
  int ox = 0, oy = 0;
  if (p.off) {  // even luma offsets in [0, 16); chroma at half
    ox = min(max(p.off[region * 2], 0), 15) / c.denom;
    oy = min(max(p.off[region * 2 + 1], 0), 15) / c.denom;
  }
  const int lim_w = (p.valid[region * 2] + c.denom - 1) / c.denom;
  const int lim_h = (p.valid[region * 2 + 1] + c.denom - 1) / c.denom;
  const int y0 = max(row * 8 - oy, 0);
  const int y1 = min(row * 8 + 8 - oy, c.out_h);
  const uint8_t fill = uint8_t(c.fill);
  if (c.out_w % 16 == 0) {
    const int chunks = c.out_w / 16;
    const int sh = 8 * (ox & 3);
    for (int k = tid; k < (y1 - y0) * chunks; k += kThreads) {
      const int oyr = y0 + k / chunks, x0 = (k % chunks) * 16;
      const uint8_t* src = band + (oyr + oy - row * 8) * W + x0 + ox;
      uint4 v;
      if (oyr < lim_h && x0 + 16 <= lim_w) {
        // inside the extent: five aligned words, shifted into four
        const uint32_t* a =
            reinterpret_cast<const uint32_t*>(src - (ox & 3));
        const uint32_t w0 = a[0], w1 = a[1], w2 = a[2], w3 = a[3];
        const uint32_t w4 = (ox & 3) ? a[4] : 0u;
        v = make_uint4(__funnelshift_r(w0, w1, sh),
                       __funnelshift_r(w1, w2, sh),
                       __funnelshift_r(w2, w3, sh),
                       __funnelshift_r(w3, w4, sh));
      } else {
        union { uint4 v; uint8_t b[16]; } u;
        const bool in_row = oyr < lim_h;
#pragma unroll
        for (int i = 0; i < 16; ++i)
          u.b[i] = (in_row && x0 + i < lim_w) ? src[i] : fill;
        v = u.v;
      }
      *reinterpret_cast<uint4*>(c.out + (region * c.out_h + oyr) *
                                            int64_t(c.out_w) + x0) = v;
    }
  } else {
    for (int k = tid; k < (y1 - y0) * c.out_w; k += kThreads) {
      const int oyr = y0 + k / c.out_w, x = k % c.out_w;
      const uint8_t v = band[(oyr + oy - row * 8) * W + x + ox];
      c.out[(region * c.out_h + oyr) * int64_t(c.out_w) + x] =
          (oyr < lim_h && x < lim_w) ? v : fill;
    }
  }
}

}  // namespace

extern "C" {

const char* dct_decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared memory of a launch whose widest component row has bw
// blocks and whose largest stage is that of these caps (the wrapper
// refuses a pack past the card's 227 KB).
int dct_decode_smem_bytes(int bw, int capbm, int capg, int capge) {
  return Layout(bw, Stage(capbm, capg).bytes).total;
}

// The three components of n regions, in the order Y, Cb, Cr. For each:
//   dc8 int8 [n, bh, bw]; bmc uint8 [n, (bl + 1) / 2]; bmb uint8
//   [n, ng * capbm]; valn uint8 [n, ng * capg / 2]; esc8 int8
//   [n, ng * capge]; aidx int32 / aval int16 [n, cap_a]; didx int32 /
//   dval int16 [n, cap_d] (ptrs[c * 9 .. c * 9 + 8] in that order);
//   out uint8 [n, out_h, out_w]; tap f32 [n, bl, 64] or null;
//   dims[c * 9 ..] = bh, bw, capbm, capg, capge, cap_a, cap_d, out_h, out_w.
// qt int32 [3, 64]; valid int32 [n, 2]; off int32 [n, 2] or null (then
// out is the whole plane); m8 the host's 8x8 IDCT basis; scratch int32
// [n * (bl_Y + bl_Cb + bl_Cr + 2 * (bh_Y + bh_Cb + bh_Cr))] for the
// pre-pass's DC and row ranges. Two launches on `stream`, the DC pre-pass
// and the decode; returns cudaGetLastError().
int dct_decode_launch(const void* const* ptrs, uint8_t* const* outs,
                      float* const* taps, const int* dims, const int32_t* qt,
                      const int32_t* valid, const int32_t* off,
                      const float* m8, int* scratch, int n, void* stream) {
  Params p;
  int rows = 0, max_bw = 0, max_stage = 0;
  for (int ci = 0; ci < 3; ++ci) {
    Comp& c = p.c[ci];
    const void* const* f = ptrs + ci * 9;
    const int* d = dims + ci * 9;
    c.dc8 = static_cast<const int8_t*>(f[0]);
    c.bmc = static_cast<const uint8_t*>(f[1]);
    c.bmb = static_cast<const uint8_t*>(f[2]);
    c.valn = static_cast<const uint8_t*>(f[3]);
    c.esc8 = static_cast<const int8_t*>(f[4]);
    c.aidx = static_cast<const int32_t*>(f[5]);
    c.aval = static_cast<const int16_t*>(f[6]);
    c.didx = static_cast<const int32_t*>(f[7]);
    c.dval = static_cast<const int16_t*>(f[8]);
    c.out = outs[ci];
    c.tap = taps ? taps[ci] : nullptr;
    c.bh = d[0], c.bw = d[1], c.capbm = d[2], c.capg = d[3], c.capge = d[4];
    c.cap_a = d[5], c.cap_d = d[6], c.out_h = d[7], c.out_w = d[8];
    c.denom = ci ? 2 : 1;
    c.fill = ci ? 128 : 255;
    c.dc = scratch;
    scratch += int64_t(n) * c.bh * c.bw;
    if (c.bh <= 0 || c.bw <= 0 || c.capbm < 0 || c.capg < 0 || c.capg % 2 ||
        c.capge < 0 || c.cap_a < 0 || c.cap_d < 0 || c.out_h <= 0 ||
        c.out_w <= 0 || c.out_w + (off ? 15 / c.denom : 0) > c.bw * 8 ||
        c.out_h + (off ? 15 / c.denom : 0) > c.bh * 8)
      return (int)cudaErrorInvalidValue;
    rows += c.bh;
    max_bw = c.bw > max_bw ? c.bw : max_bw;
    const int sb = Stage(c.capbm, c.capg).bytes;
    max_stage = sb > max_stage ? sb : max_stage;
  }
  const int smem = Layout(max_bw, max_stage).total;
  for (int i = 0; i < 64; ++i) p.m[i] = m8[i];
  p.qt = qt;
  p.valid = valid;
  p.off = off;
  p.rng = scratch;
  p.rows = rows;
  p.max_bw = max_bw;
  p.max_stage = max_stage;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(unsigned(int64_t(n) * rows));
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dc_kernel<<<grid, kDcThreads, max_bw * 4, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_kernel<<<grid, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
