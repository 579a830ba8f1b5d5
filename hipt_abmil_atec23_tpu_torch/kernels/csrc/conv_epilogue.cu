// The epilogue of a ResNet convolution in one pass, for Hopper (sm_90a):
//
//   y = relu(a + bias_a[c] [+ (r [+ bias_r[c]])]),
//
// over NHWC (channels_last) tensors, c the channel of each element. `a` is
// the convolution's own output (cuDNN, run without bias) and y is written
// in place into it; `r` is a block's residual: its input, or its
// downsample convolution's bias-free output with that convolution's
// folded bias as bias_r.
//
// There is no TPU kernel for this: the JAX package leaves the ResNet's
// bias, residual add and ReLU to XLA, which fuses them into its
// convolutions. Eager PyTorch ran them as up to four passes over the
// activations: the bias as a broadcast add_ of a [1, C, 1, 1] tensor onto
// a channels_last output (PyTorch's generic, non-vectorized
// elementwise_kernel), the ReLU's clamp, the residual add and its ReLU,
// each rounding to the output dtype. Here every element is read once (and
// its residual once) and written once. The sum is taken in f32 in the
// plain version's order, (a + bias_a) + (r + bias_r), each an explicit
// __fadd_rn so nvcc contracts nothing, and rounded once to the output
// dtype (ops/conv_epilogue.conv_epilogue_reference is the same function).
//
// Layout: channels_last makes the flat offset i of an element hold channel
// i % C. C % 8 == 0, so a thread's 16-byte vector (8 bf16 or 4 f32) lies
// in one pixel and its channels are c .. c + 7 (or + 3) with c a multiple
// of the vector. The biases are read once per CTA into shared memory as
// f32, and from there into each thread's registers. A grid-stride loop
// over up to 8 CTAs of 256 threads per SM keeps 16 or 32 bytes per thread
// in flight. The launcher rounds the grid up so that C divides the
// stride, so a thread keeps one channel group and its biases for the whole
// loop (the ResNets' power-of-two widths need no rounding at the full
// grid).
//
// Bound on this card: device memory. Without a residual 4 bytes per bf16
// element move (read and write), with one 6; the operations (one to four
// per element) are far under that.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;
constexpr int kMaxChannels = 4096;  // two f32 bias rows: 32 KB of smem

template <typename T>
struct Vec16;  // one 16-byte vector as f32

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec16<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(float v) { return v; }

// n consecutive f32 of a shared-memory row from channel c (c % n == 0)
template <int n>
__device__ __forceinline__ void bias_vec(const float* row, int c, float* b) {
#pragma unroll
  for (int i = 0; i < n / 4; ++i) {
    const float4 t = reinterpret_cast<const float4*>(row + c)[i];
    b[4 * i] = t.x;
    b[4 * i + 1] = t.y;
    b[4 * i + 2] = t.z;
    b[4 * i + 3] = t.w;
  }
}

template <typename T, bool kRes, bool kBiasR>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_kernel(T* __restrict__ a, const T* __restrict__ bias_a,
                     const T* __restrict__ r, const T* __restrict__ bias_r,
                     int64_t nvec, int C) {
  using V = Vec16<T>;
  extern __shared__ float4 smem[];  // bias_a [C], then bias_r [C], as f32
  float* sb = reinterpret_cast<float*>(smem);
  for (int i = threadIdx.x; i < C; i += kThreads) {
    sb[i] = to_f(bias_a[i]);
    if (kBiasR) sb[C + i] = to_f(bias_r[i]);
  }
  __syncthreads();

  const int64_t stride = int64_t(gridDim.x) * kThreads;
  int64_t v = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  // this thread's channels, the same at every step (C divides the stride)
  const int c = int((v * V::n) % C);
  float ba[V::n], br[V::n];
  bias_vec<V::n>(sb, c, ba);
  if (kBiasR) bias_vec<V::n>(sb + C, c, br);
  for (; v < nvec; v += stride) {
    float x[V::n];
    V::load(a + v * V::n, x);
    float y[V::n];
    if (kRes) V::load(r + v * V::n, y);
#pragma unroll
    for (int j = 0; j < V::n; ++j) {
      float s = __fadd_rn(x[j], ba[j]);
      if (kRes) s = __fadd_rn(s, kBiasR ? __fadd_rn(y[j], br[j]) : y[j]);
      x[j] = s < 0.0f ? 0.0f : s;  // NaN passes, as torch.relu's
    }
    V::store(a + v * V::n, x);
  }
}

int gcd(int x, int y) { return y == 0 ? x : gcd(y, x % y); }

template <typename T>
int launch(T* a, const T* ba, const T* r, const T* br, int64_t n, int C,
           int sms, cudaStream_t s) {
  constexpr int per_cta = kThreads * Vec16<T>::n;  // elements per CTA step
  const int64_t nvec = n / Vec16<T>::n;
  const int64_t want = (nvec + kThreads - 1) / kThreads;
  int64_t grid = want < int64_t(sms) * kCtasPerSm
                     ? want : int64_t(sms) * kCtasPerSm;
  // round up to a multiple of q, so that C divides grid * per_cta: CTAs
  // past the end find no vector to take
  const int q = C / gcd(C, per_cta);
  grid = (grid + q - 1) / q * q;
  const size_t smem = size_t(br != nullptr ? 2 : 1) * C * sizeof(float);
  if (r == nullptr)
    conv_epilogue_kernel<T, false, false>
        <<<int(grid), kThreads, smem, s>>>(a, ba, r, br, nvec, C);
  else if (br == nullptr)
    conv_epilogue_kernel<T, true, false>
        <<<int(grid), kThreads, smem, s>>>(a, ba, r, br, nvec, C);
  else
    conv_epilogue_kernel<T, true, true>
        <<<int(grid), kThreads, smem, s>>>(a, ba, r, br, nvec, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* conv_epilogue_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// a [n / C, C] in place (an NHWC / channels_last tensor's memory), bias_a
// [C]; r like a or null; bias_r [C] or null (only with r); all bf16 when
// is_bf16 else f32, 16-byte aligned, C % 8 == 0 and C <= 4096, n % C == 0.
// sms: the card's SM count (the grid is capped near 8 CTAs per SM). One
// launch on `stream`; returns cudaGetLastError().
int conv_epilogue_launch(void* a, const void* bias_a, const void* r,
                         const void* bias_r, int is_bf16, int64_t n, int C,
                         int sms, void* stream) {
  if (n <= 0 || C <= 0 || C % 8 != 0 || C > kMaxChannels || n % C != 0 ||
      sms <= 0 || (r == nullptr && bias_r != nullptr) ||
      ((uintptr_t(a) | uintptr_t(r)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch(static_cast<__nv_bfloat16*>(a),
                  static_cast<const __nv_bfloat16*>(bias_a),
                  static_cast<const __nv_bfloat16*>(r),
                  static_cast<const __nv_bfloat16*>(bias_r), n, C, sms, s);
  return launch(static_cast<float*>(a), static_cast<const float*>(bias_a),
                static_cast<const float*>(r),
                static_cast<const float*>(bias_r), n, C, sms, s);
}

}  // extern "C"
