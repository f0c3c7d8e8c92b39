// Fused depthwise conv + per-channel affine + activation + channel mask, for
// Hopper (sm_90a), in NHWC.
//
//   y[n,oh,ow,c] = act(sum_{i,j} x[n, oh*s-p+i, ow*s-p+j, c] * w[i,j,c]
//                      * scale[c] + shift[c]) * mask[c],   p = k/2, zero pad
//
// Replaces the repo's one TPU kernel: yet_another_mobilenet_series_tpu/
// ops/pallas_kernels.py (_dw_kernel, launched by _fused_dw_fwd's
// pl.pallas_call). The TPU kernel's stride^2 phase planes, 128-channel
// blocks and row slabs were workarounds for Mosaic and VMEM; none of them
// is carried over.
//
// What bounds it on an H100: bytes. A depthwise stage does about 2*k*k
// flops per output element and reads each input element about k*k/s^2
// times from L1/L2 but once from device memory, so at MobileNetV3-Large
// shapes the least time is (bytes of x + bytes of y) / memory bandwidth.
// This first version is the simple design that is right: one thread per
// output element, the channel index fastest so a warp's loads of one tap
// are contiguous, the k*k taps read through L1/L2 with a bounds check for
// the zero pad, accumulation in f32, the epilogue fused, and one store.
// Shared-memory tiles with halos, 16-byte vector loads and TMA are later
// work.
//
// Built by ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C interface, no PyTorch headers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// activation codes: ops/activations.py ACT_CODES
enum ActCode {
  kIdentity = 0,
  kRelu = 1,
  kRelu6 = 2,
  kHswish = 3,
  kHsigmoid = 4,
  kSwish = 5,
  kSigmoid = 6,
};

__device__ __forceinline__ float relu6f(float v) { return fminf(fmaxf(v, 0.0f), 6.0f); }

// stable in both directions: exp of a non-positive argument only
__device__ __forceinline__ float sigmoidf(float v) {
  if (v >= 0.0f) {
    return 1.0f / (1.0f + expf(-v));
  }
  float e = expf(v);
  return e / (1.0f + e);
}

// same formulas and operation order as ops/activations.py
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.0f);
    case kRelu6: return relu6f(v);
    case kHswish: return v * relu6f(v + 3.0f) * (1.0f / 6.0f);
    case kHsigmoid: return relu6f(v + 3.0f) * (1.0f / 6.0f);
    case kSwish: return v * sigmoidf(v);
    case kSigmoid: return sigmoidf(v);
    default: return v;
  }
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T>
__device__ __forceinline__ T store_cast(float v);
template <>
__device__ __forceinline__ float store_cast<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_cast<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

template <typename T>
__global__ void fused_dw_kernel(const T* __restrict__ x, const float* __restrict__ w,
                                const float* __restrict__ scale, const float* __restrict__ shift,
                                const float* __restrict__ mask, T* __restrict__ y, int n, int h,
                                int wd, int c, int oh, int ow, int k, int stride, int act) {
  const int pad = k / 2;
  const int64_t total = (int64_t)n * oh * ow * c;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total; idx += step) {
    const int ch = (int)(idx % c);
    int64_t rest = idx / c;
    const int ox = (int)(rest % ow);
    rest /= ow;
    const int oy = (int)(rest % oh);
    const int img = (int)(rest / oh);
    const int iy0 = oy * stride - pad;
    const int ix0 = ox * stride - pad;
    const T* xb = x + (int64_t)img * h * wd * c + ch;
    float acc = 0.0f;
    for (int i = 0; i < k; ++i) {
      const int iy = iy0 + i;
      if (iy < 0 || iy >= h) continue;
      for (int j = 0; j < k; ++j) {
        const int ix = ix0 + j;
        if (ix < 0 || ix >= wd) continue;
        acc += load_f32(xb + ((int64_t)iy * wd + ix) * c) * __ldg(w + (i * k + j) * c + ch);
      }
    }
    float v = acc * __ldg(scale + ch) + __ldg(shift + ch);
    v = activate(v, act) * __ldg(mask + ch);
    y[idx] = store_cast<T>(v);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* scale, const void* shift,
                   const void* mask, void* y, int n, int h, int wd, int c, int k, int stride,
                   int act, cudaStream_t stream) {
  const int oh = (h - 1) / stride + 1;
  const int ow = (wd - 1) / stride + 1;
  const int64_t total = (int64_t)n * oh * ow * c;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride covers the rest
  fused_dw_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const float*>(mask), static_cast<T*>(y), n, h,
      wd, c, oh, ow, k, stride, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and y); w (k,k,C), scale, shift and
// mask (C,) are float32. All pointers are device pointers of contiguous
// tensors; the launch goes on `stream` and does not synchronize. Returns
// cudaGetLastError() after the launch (0 = launched).
int yamt_fused_depthwise(const void* x, const void* w, const void* scale, const void* shift,
                         const void* mask, void* y, int n, int h, int wd, int c, int k,
                         int stride, int act, int dtype, void* stream) {
  if (n < 0 || h < 1 || wd < 1 || c < 1 || k < 1 || (k % 2) == 0 || stride < 1 || act < 0 ||
      act > kSigmoid) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(x, w, scale, shift, mask, y, n, h, wd, c, k, stride, act, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, w, scale, shift, mask, y, n, h, wd, c, k, stride, act, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* yamt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
