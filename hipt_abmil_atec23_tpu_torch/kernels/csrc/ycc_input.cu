// uint8 YCbCr planes -> the encoder's normalized input [n, H, W, 3], in one
// launch, for Hopper (sm_90a).
//
// There is no TPU kernel for this: the JAX package's ops/yuv.py
// yuv420_to_rgb / yuv422_to_rgb and the encoder's x / 127.5 - 1 are XLA
// ops that XLA fuses into one program. Eager PyTorch ran them op by op
// (f32 chroma, two upsampled copies through cat and stack per plane, an
// f32 RGB image, then the normalize and the cast), several hundred MB of
// device memory traffic per region. This kernel reads each plane and
// writes the input once.
//
// One thread makes 16 pixels of one row: 16 Y samples (one 16-byte load
// where W % 16 == 0 and the planes are 16-byte aligned) and, per chroma
// plane, the 8 chroma samples under them plus one on each side (the halo,
// clamped at the edges of the given planes), from the two chroma rows the
// row's vertical filter reads (4:2:0) or its own row (4:2:2). The steps
// and their order are the plain version's (ops/yuv.ycc_to_input_reference),
// in f32:
//
//   c -= 128; 4:2:0: v = (3 c[i] + c[i -/+ 1]) * 0.25 along H (even / odd
//   output row), then along W the same with v; JFIF colour
//   r = y + 1.402 cr, g = (y - 0.344136 cb) - 0.714136 cr, b = y + 1.772 cb;
//   clamp to 0..255; x * (1 / 127.5f) - 1 (PyTorch's CUDA true division by
//   a scalar multiplies by its f32 reciprocal); round to bf16 or keep f32.
//
// Every product and sum is an explicit __fmul_rn / __fadd_rn, so nvcc
// contracts nothing into an FMA and the kernel equals the plain version
// run on the card bit for bit. The upsample's values are multiples of
// 1/16 and exact in f32.
//
// Bound on this card: device memory. Two 4096^2 regions read 50 MB of
// planes and write 201 MB of bf16 input (403 MB in f32); ~29 f32
// operations per pixel are far under that. The output leaves in 16-byte
// stores (6 per thread in bf16, 12 in f32) where W % 16 == 0, scalar
// stores otherwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPx = 16;        // pixels per thread
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(uint8_t v) { return float(v); }

// 10 chroma samples of one row, c[k] = row[clamp(cx0 - 1 + k, 0, cw - 1)]
// - 128.
__device__ __forceinline__ void chroma_row(const uint8_t* row, int cx0,
                                           int cw, bool vec, float* c) {
  if (vec) {  // cw % 8 == 0, cx0 % 8 == 0: cx0 .. cx0 + 7 in range
    union { uint2 v; uint8_t b[8]; } u;
    u.v = *reinterpret_cast<const uint2*>(row + cx0);
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i + 1] = to_f(u.b[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i + 1] = to_f(row[min(cx0 + i, cw - 1)]);
  }
  c[0] = to_f(row[max(cx0 - 1, 0)]);
  c[9] = to_f(row[min(cx0 + 8, cw - 1)]);
#pragma unroll
  for (int i = 0; i < 10; ++i) c[i] = __fadd_rn(c[i], -128.0f);
}

// (3 a + b) * 0.25, the triangular filter's tap pair
__device__ __forceinline__ float tri(float a, float b) {
  return __fmul_rn(__fadd_rn(__fmul_rn(3.0f, a), b), 0.25f);
}

__device__ __forceinline__ float norm(float v) {
  v = fminf(fmaxf(v, 0.0f), 255.0f);
  return __fadd_rn(__fmul_rn(v, 1.0f / 127.5f), -1.0f);
}

// 16-byte stores of a thread's kPx * 3 outputs
__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* v) {
#pragma unroll
  for (int i = 0; i < kPx * 3 / 8; ++i)
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(
        bf16x2(v[8 * i], v[8 * i + 1]), bf16x2(v[8 * i + 2], v[8 * i + 3]),
        bf16x2(v[8 * i + 4], v[8 * i + 5]),
        bf16x2(v[8 * i + 6], v[8 * i + 7]));
}
__device__ __forceinline__ void store16(float* dst, const float* v) {
#pragma unroll
  for (int i = 0; i < kPx * 3 / 4; ++i)
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(
        __float_as_uint(v[4 * i]), __float_as_uint(v[4 * i + 1]),
        __float_as_uint(v[4 * i + 2]), __float_as_uint(v[4 * i + 3]));
}
__device__ __forceinline__ void store1(__nv_bfloat16* d, float v) {
  *d = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store1(float* d, float v) { *d = v; }

template <typename OutT, bool k420>
__global__ void __launch_bounds__(kThreads)
ycc_kernel(const uint8_t* __restrict__ yp, const uint8_t* __restrict__ cbp,
           const uint8_t* __restrict__ crp, OutT* __restrict__ out,
           int64_t tasks, int H, int W, int CH, int CW, bool vec) {
  const int64_t t = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= tasks) return;
  const int chunks = (W + kPx - 1) / kPx;
  const int64_t rowid = t / chunks;             // region * H + row
  const int x0 = int(t - rowid * chunks) * kPx;
  const int64_t region = rowid / H;
  const int yy = int(rowid - region * H);
  const int npx = min(kPx, W - x0);

  float y[kPx];
  const uint8_t* yrow = yp + rowid * W;
  if (vec) {
    union { uint4 v; uint8_t b[16]; } u;
    u.v = *reinterpret_cast<const uint4*>(yrow + x0);
#pragma unroll
    for (int i = 0; i < kPx; ++i) y[i] = to_f(u.b[i]);
  } else {
#pragma unroll
    for (int i = 0; i < kPx; ++i) y[i] = to_f(yrow[min(x0 + i, W - 1)]);
  }

  // chroma columns cx0 - 1 .. cx0 + 8 after the vertical filter
  const int cx0 = x0 / 2;
  float cb[10], cr[10];
  {
    const int cy = k420 ? yy >> 1 : yy;
    const int64_t base = region * CH;
    chroma_row(cbp + (base + cy) * CW, cx0, CW, vec, cb);
    chroma_row(crp + (base + cy) * CW, cx0, CW, vec, cr);
    if (k420) {
      const int cn = (yy & 1) ? min(cy + 1, CH - 1) : max(cy - 1, 0);
      float nb[10], nr[10];
      chroma_row(cbp + (base + cn) * CW, cx0, CW, vec, nb);
      chroma_row(crp + (base + cn) * CW, cx0, CW, vec, nr);
#pragma unroll
      for (int i = 0; i < 10; ++i) {
        cb[i] = tri(cb[i], nb[i]);
        cr[i] = tri(cr[i], nr[i]);
      }
    }
  }
  // cb[k] holds chroma column clamp(cx0 - 1 + k), so the neighbours of
  // the edge columns are the clamped ones, as the plain version's
  float o[kPx * 3];
#pragma unroll
  for (int i = 0; i < kPx; ++i) {
    const int j = (i >> 1) + 1;           // this pixel's chroma column
    const int nb = (i & 1) ? j + 1 : j - 1;
    const float u = tri(cb[j], cb[nb]);
    const float v = tri(cr[j], cr[nb]);
    const float r = __fadd_rn(y[i], __fmul_rn(1.402f, v));
    const float g = __fadd_rn(__fadd_rn(y[i], -__fmul_rn(0.344136f, u)),
                              -__fmul_rn(0.714136f, v));
    const float b = __fadd_rn(y[i], __fmul_rn(1.772f, u));
    o[i * 3] = norm(r);
    o[i * 3 + 1] = norm(g);
    o[i * 3 + 2] = norm(b);
  }
  OutT* dst = out + (rowid * W + x0) * 3;
  if (vec) {
    store16(dst, o);
  } else {
#pragma unroll
    for (int i = 0; i < kPx * 3; ++i)
      if (i < npx * 3) store1(dst + i, o[i]);
  }
}

template <typename OutT>
int launch(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, OutT* out,
           int n, int H, int W, int CH, int CW, cudaStream_t s) {
  const int64_t tasks = int64_t(n) * H * ((W + kPx - 1) / kPx);
  // 16-byte rows: whole 16-pixel chunks on 16-byte aligned planes
  const bool vec = W % kPx == 0 &&
                   ((uintptr_t(y) | uintptr_t(cb) | uintptr_t(cr) |
                     uintptr_t(out)) & 15) == 0;
  const dim3 grid(unsigned((tasks + kThreads - 1) / kThreads));
  if (CH == H)
    ycc_kernel<OutT, false><<<grid, kThreads, 0, s>>>(y, cb, cr, out, tasks,
                                                      H, W, CH, CW, vec);
  else
    ycc_kernel<OutT, true><<<grid, kThreads, 0, s>>>(y, cb, cr, out, tasks,
                                                     H, W, CH, CW, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ycc_input_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// y uint8 [n, H, W]; cb, cr uint8 [n, CH, CW] with CW * 2 == W and
// CH * 2 == H (4:2:0) or CH == H (4:2:2); out [n, H, W, 3], bf16 when
// out_bf16 else f32. One launch on `stream`; returns cudaGetLastError().
int ycc_input_launch(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                     void* out, int out_bf16, int n, int H, int W, int CH,
                     int CW, void* stream) {
  if (n <= 0 || H <= 0 || W <= 0 || CW * 2 != W ||
      (CH * 2 != H && CH != H))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return out_bf16 ? launch(y, cb, cr, static_cast<__nv_bfloat16*>(out), n, H,
                           W, CH, CW, s)
                  : launch(y, cb, cr, static_cast<float*>(out), n, H, W, CH,
                           CW, s);
}

}  // extern "C"
