// LongNet's dilated attention over one slide's tokens, as Prov-GigaPath's
// slide encoder runs it (torchscale's DilatedAttention), for Hopper
// (sm_90a). ops/dilated_attention.py holds the definition, the plain
// version and the launch plan; this file holds the two kernels:
//
//   dilated_attention_kernel  one CTA of kWarps warps per (branch, segment,
//                             head, block of kBlockM selected queries), every
//                             branch in one grid, the plan's heaviest branch
//                             first. A warp holds 16 queries' Q as mma.sync
//                             m16n8k16 A fragments and walks the selected
//                             keys of its (segment, head group), rows
//                             row0 + r t of q, k, v, in tiles of kBlockN
//                             through a two-stage cp.async ring: S = Q K^T
//                             on the tensor cores, an f32 online softmax in
//                             base 2, P rounded to bf16 and O += P V.
//                             Keys of the segment past the bag's last token
//                             are zero rows: in a walked tile they are
//                             zero-filled (logit 0, value 0); those in tiles
//                             past the last token are added analytically
//                             (exp(0 - m) each to the denominator, nothing
//                             to the numerator). It writes o_b (f32) and
//                             lse_b into a compact buffer: branch b holds
//                             H / r columns per token, since each token is
//                             selected by one head group per branch.
//   dilated_merge_kernel      per (token, head, 8 channels): the softmax of
//                             the branches' lse (an lse of exactly 0 or an
//                             unselecting branch counts as -1e8, as
//                             torchscale's merge reads it) and the weighted
//                             sum of their o_b in f32, written once in bf16.
//
// Head sizes 16, 32, 48 and 64: any multiple of 16 fits m16n8k16 without
// padding; at 48 the third k16 chunk of Q K^T reads two key blocks with one
// ldmatrix.x4. There is no TPU kernel for this: the JAX package has no
// slide-level transformer. Bound on this card: the tensor cores (4 d
// operations per (query, key) pair); the merge and the compact buffer are
// memory-bound and small beside it.
#include "hopper.cuh"

namespace {

using hk::bf16;

constexpr int kMaxBranches = 8;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockM = 16 * kWarps;  // selected queries per CTA
constexpr int kBlockN = 64;           // selected keys per tile
constexpr int kMergeThreads = 256;
constexpr float kUnselected = -1e8f;
constexpr float kLn2 = 0.6931471805599453f;

// One launch's branches, ordered by their first CTA: per branch w' =
// min(w, N), r, L = ceil(w' / r) positions per segment and head group,
// query blocks per (segment, head), the first CTA, heads per group and the
// first column of the compact buffer.
struct Plan {
  int nb;
  int w[kMaxBranches], r[kMaxBranches], len[kMaxBranches];
  int tiles[kMaxBranches], first[kMaxBranches], hg[kMaxBranches];
  int col[kMaxBranches];
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// S[16 x 8 NT] = Q . K[0 .. 8 NT)^T for one warp's 16 rows, K rows LD apart
template <int HD, int NT>
__device__ __forceinline__ void qk_scores(float (&s)[NT][4],
                                          const uint32_t (&qa)[HD / 16][4],
                                          const bf16* Ks) {
  constexpr int LD = HD + 8;
  constexpr int KC = HD / 16;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const int r = nt * 8 + (lane & 7);
#pragma unroll
    for (int kc = 0; kc + 1 < KC; kc += 2) {
      uint32_t b[4];  // b0, b1 of chunks kc and kc + 1
      hk::ldmatrix_x4(b, Ks + r * LD + 8 * (2 * kc + (lane >> 3)));
      hk::mma16816(s[nt], qa[kc], b[0], b[1]);
      hk::mma16816(s[nt], qa[kc + 1], b[2], b[3]);
    }
  }
  if (KC % 2) {  // the last chunk of key blocks nt and nt + 1 at once
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      const int r = (nt + (lane >> 4)) * 8 + (lane & 7);
      hk::ldmatrix_x4(b,
                      Ks + r * LD + 16 * (KC - 1) + 8 * ((lane >> 3) & 1));
      hk::mma16816(s[nt], qa[KC - 1], b[0], b[1]);
      hk::mma16816(s[nt + 1], qa[KC - 1], b[2], b[3]);
    }
  }
}

// keys t0 .. t0 + kBlockN of the (segment, head group): rows row0 + r t of
// k and v (head columns at ``hoff``), zero rows for t >= n_real
template <int HD>
__device__ __forceinline__ void load_tile(bf16* Ks, bf16* Vs, const bf16* k,
                                          const bf16* v, long long sk,
                                          long long sv, long long row0,
                                          int r, int hoff, int t0,
                                          int n_real) {
  constexpr int LD = HD + 8;
  constexpr int VPR = HD / 8;  // 16-byte vectors per row
  for (int e = threadIdx.x; e < kBlockN * VPR; e += kThreads) {
    const int i = e / VPR, c = (e % VPR) * 8;
    const bool in = t0 + i < n_real;
    const long long row = in ? row0 + (long long)r * (t0 + i) : 0;
    hk::cp_async16(Ks + i * LD + c, k + row * sk + hoff + c, in);
    hk::cp_async16(Vs + i * LD + c, v + row * sv + hoff + c, in);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    dilated_attention_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v, float* __restrict__ o,
                             float* __restrict__ lse_out, int n, int heads,
                             long long sq, long long sk, long long sv,
                             int cols, float c, const Plan plan) {
  constexpr int LD = HD + 8;
  constexpr int KC = HD / 16;
  constexpr int DN = HD / 8;
  constexpr int NT = kBlockN / 8;
  // two stages of K and V tiles (bf16 bits), rows LD apart: conflict-free
  // ldmatrix
  __shared__ __align__(128) uint16_t kv_smem[2][2][kBlockN * LD];

  const int pid = blockIdx.x;
  int b = 0;
#pragma unroll
  for (int i = 1; i < kMaxBranches; ++i)
    b += (i < plan.nb && pid >= plan.first[i]);
  const int w = plan.w[b], r = plan.r[b], length = plan.len[b];
  const int local = pid - plan.first[b];
  const int tile = local % plan.tiles[b];
  const int rest = local / plan.tiles[b];
  const int head = rest % heads, seg = rest / heads;
  const int j = head / plan.hg[b];
  const int lim = min(w, n - seg * w);
  const int n_real = (lim - j + r - 1) / r;  // the group's tokens: a prefix
  if (tile * kBlockM >= n_real) return;
  const long long row0 = (long long)seg * w + j;
  const int hoff = head * HD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tq0 = tile * kBlockM + warp * 16 + (lane >> 2);
  const int tq1 = tq0 + 8;
  const bool in0 = tq0 < n_real, in1 = tq1 < n_real;
  const long long rq0 = row0 + (long long)r * tq0;
  const long long rq1 = row0 + (long long)r * tq1;

  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int cc = hoff + kc * 16 + 2 * (lane & 3);
    qa[kc][0] = in0 ? *reinterpret_cast<const uint32_t*>(q + rq0 * sq + cc)
                    : 0u;
    qa[kc][1] = in1 ? *reinterpret_cast<const uint32_t*>(q + rq1 * sq + cc)
                    : 0u;
    qa[kc][2] = in0 ? *reinterpret_cast<const uint32_t*>(
                          q + rq0 * sq + cc + 8) : 0u;
    qa[kc][3] = in1 ? *reinterpret_cast<const uint32_t*>(
                          q + rq1 * sq + cc + 8) : 0u;
  }

  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m[2] = {hk::kNegInf, hk::kNegInf}, l[2] = {0.f, 0.f}, alpha[2];

  const int n_tiles = (n_real + kBlockN - 1) / kBlockN;
  auto Ks = [&](int i) { return reinterpret_cast<bf16*>(kv_smem[i][0]); };
  auto Vs = [&](int i) { return reinterpret_cast<bf16*>(kv_smem[i][1]); };
  load_tile<HD>(Ks(0), Vs(0), k, v, sk, sv, row0, r, hoff, 0, n_real);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<HD>(Ks(buf ^ 1), Vs(buf ^ 1), k, v, sk, sv, row0, r, hoff,
                    (t + 1) * kBlockN, n_real);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[NT][4];
    qk_scores<HD, NT>(s, qa, Ks(buf));
    // a pad of the segment scores 0 (zero-filled); past the segment, -inf
    hk::softmax_step<NT>(s, m, l, alpha, t * kBlockN, length, c);
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }
    uint32_t p[2 * NT];
    hk::pack_p<NT>(p, s);
    const bf16* vt = Vs(buf);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const int vr = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dn = 0; dn < DN; dn += 2) {
        uint32_t vb[4];  // b0, b1 of channel blocks dn and dn + 1
        hk::ldmatrix_x4_trans(vb, vt + vr * LD + 8 * (dn + (lane >> 4)));
        hk::mma16816(acc[dn], &p[4 * kk], vb[0], vb[1]);
        hk::mma16816(acc[dn + 1], &p[4 * kk], vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

  // the pads in tiles past the last token: logit 0, value 0 each
  const int walked = min(n_tiles * kBlockN, length);
  const float n_pad = (float)(length - walked);
  float scale[2], lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mn = n_pad > 0.f ? fmaxf(m[i], 0.f) : m[i];
    const float a = hk::ex2(m[i] - mn);
    const float den = hk::quad_sum(l[i]) * a + n_pad * hk::ex2(-mn);
    scale[i] = a / den;
    lse[i] = (mn + __log2f(den)) * kLn2;
  }
  const int col = plan.col[b] + head % plan.hg[b];
  const int q2 = 2 * (lane & 3);
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int cc = col * HD + dn * 8 + q2;
    if (in0)
      *reinterpret_cast<float2*>(o + (size_t)rq0 * cols * HD + cc) =
          make_float2(acc[dn][0] * scale[0], acc[dn][1] * scale[0]);
    if (in1)
      *reinterpret_cast<float2*>(o + (size_t)rq1 * cols * HD + cc) =
          make_float2(acc[dn][2] * scale[1], acc[dn][3] * scale[1]);
  }
  if ((lane & 3) == 0) {
    if (in0) lse_out[(size_t)rq0 * cols + col] = lse[0];
    if (in1) lse_out[(size_t)rq1 * cols + col] = lse[1];
  }
}

// one thread per (token, head, 8 channels)
template <int HD>
__global__ void __launch_bounds__(kMergeThreads)
    dilated_merge_kernel(const float* __restrict__ o,
                         const float* __restrict__ lse,
                         bf16* __restrict__ out, int n, int heads, int cols,
                         const Plan plan) {
  constexpr int VPR = HD / 8;
  const long long idx = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (idx >= (long long)n * heads * VPR) return;
  const int chunk = (int)(idx % VPR);
  const long long rest = idx / VPR;
  const int head = (int)(rest % heads);
  const long long p = rest / heads;
  float lb[kMaxBranches];
  int cb[kMaxBranches];
  float mx = kUnselected;
#pragma unroll
  for (int b = 0; b < kMaxBranches; ++b) {
    lb[b] = kUnselected;
    cb[b] = -1;
    if (b < plan.nb &&
        (int)((p % plan.w[b]) % plan.r[b]) == head / plan.hg[b]) {
      cb[b] = plan.col[b] + head % plan.hg[b];
      const float x = lse[p * cols + cb[b]];
      lb[b] = x == 0.f ? kUnselected : x;
    }
    mx = fmaxf(mx, lb[b]);
  }
  float den = 0.f, acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int b = 0; b < kMaxBranches; ++b) {
    if (b >= plan.nb) break;
    const float wgt = __expf(lb[b] - mx);
    den += wgt;
    if (cb[b] < 0) continue;
    const float4* src = reinterpret_cast<const float4*>(
        o + (p * cols + cb[b]) * HD + chunk * 8);
    const float4 x0 = src[0], x1 = src[1];
    acc[0] += wgt * x0.x;
    acc[1] += wgt * x0.y;
    acc[2] += wgt * x0.z;
    acc[3] += wgt * x0.w;
    acc[4] += wgt * x1.x;
    acc[5] += wgt * x1.y;
    acc[6] += wgt * x1.z;
    acc[7] += wgt * x1.w;
  }
  const float inv = 1.f / den;
  uint32_t packed[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    packed[i] = hk::pack_bf16(acc[2 * i] * inv, acc[2 * i + 1] * inv);
  *reinterpret_cast<uint4*>(out + p * heads * HD + head * HD + chunk * 8) =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

template <int HD>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, float* o,
                   float* lse, bf16* out, int n, int heads, long long sq,
                   long long sk, long long sv, int cols, float c,
                   const Plan& plan, int programs, cudaStream_t stream) {
  dilated_attention_kernel<HD><<<programs, kThreads, 0, stream>>>(
      q, k, v, o, lse, n, heads, sq, sk, sv, cols, c, plan);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long items = (long long)n * heads * (HD / 8);
  const int grid = (int)((items + kMergeThreads - 1) / kMergeThreads);
  dilated_merge_kernel<HD><<<grid, kMergeThreads, 0, stream>>>(
      o, lse, out, n, heads, cols, plan);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v [n, heads, hd] bf16 (rows sq, sk, sv elements apart, heads
// dense); o [n, cols, hd] and lse [n, cols] f32 scratch; out [n, heads hd]
// bf16. ``rows`` holds nb host rows of 8 ints: w', r, L, segments, query
// blocks, first CTA, heads per group, first column (the plan of
// ops/dilated_attention.kernel_plan, ordered by first CTA). c = hd^-1/2
// log2(e). Returns the first CUDA error of the two launches.
int dilated_attention_launch(const void* q, const void* k, const void* v,
                             void* o, void* lse, void* out, int n, int heads,
                             int hd, long long sq, long long sk, long long sv,
                             const int* rows, int nb, int programs, int cols,
                             float c, void* stream) {
  if (nb < 1 || nb > kMaxBranches) return (int)cudaErrorInvalidValue;
  Plan plan = {};
  plan.nb = nb;
  for (int b = 0; b < nb; ++b) {
    const int* x = rows + 8 * b;
    plan.w[b] = x[0];
    plan.r[b] = x[1];
    plan.len[b] = x[2];
    plan.tiles[b] = x[4];
    plan.first[b] = x[5];
    plan.hg[b] = x[6];
    plan.col[b] = x[7];
  }
  const bf16 *qb = static_cast<const bf16*>(q),
             *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  float *ob = static_cast<float*>(o), *lb = static_cast<float*>(lse);
  bf16* outb = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return (int)launch<16>(qb, kb, vb, ob, lb, outb, n, heads, sq, sk, sv,
                             cols, c, plan, programs, s);
    case 32:
      return (int)launch<32>(qb, kb, vb, ob, lb, outb, n, heads, sq, sk, sv,
                             cols, c, plan, programs, s);
    case 48:
      return (int)launch<48>(qb, kb, vb, ob, lb, outb, n, heads, sq, sk, sv,
                             cols, c, plan, programs, s);
    case 64:
      return (int)launch<64>(qb, kb, vb, ob, lb, outb, n, heads, sq, sk, sv,
                             cols, c, plan, programs, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* dilated_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
