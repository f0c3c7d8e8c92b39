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
// This tiled kernel replaced the first port's one-thread-per-output kernel,
// which did three 64-bit divides per output, k*k scalar 4-byte loads of x
// and of the taps per output, each behind a bounds check, and no 16-byte
// access. That kernel ran 9.3x above its bound and 2.8x slower than cuDNN's
// depthwise conv (PERF.md).
//
// What bounds it on an H100: bytes. Depthwise conv has no contraction over
// channels: about 2*k*k flops per output element against at least 8 bytes
// (f32 in and out), under 7 flop/byte where the card's f32 ratio is 20. So
// the least time is (bytes of x + bytes of y) / memory bandwidth, and the
// design spends everything on moving each byte once, in wide accesses:
//
// - One block, one output tile: TH x TW pixels of one image over a chunk of
//   CB channels. The block decodes its tile from blockIdx once, in 32-bit
//   arithmetic; its loops step their indices by carries, with no divide.
// - Its input tile with the halo, ((TH-1)*s+k) x ((TW-1)*s+k) x CB, goes to
//   shared memory by 16-byte cp.async copies; a copy whose source lies in
//   the zero pad has src-size 0 and fills zeros, so no tap is bounds-checked.
//   The taps, scale, shift and mask follow by cp.async too, once per block,
//   so that their latency overlaps the input's (as synchronous loads they
//   cost a DRAM round trip per loop turn before any compute).
// - Each thread computes R consecutive output columns of one row for one
//   16-byte channel vector (4 f32 or 8 bf16 channels): per tap row it holds
//   that row's taps in registers and streams the (R-1)*s+k inputs of the row
//   once each from shared memory, so each value read feeds up to k/s outputs.
// - The staged tile is padded so that a warp's 16-byte loads fall on
//   distinct shared-memory banks; the layout (pad, row pitch) comes with the
//   tiling from ops/fused_depthwise.py staged_layout().
// - The epilogue (scale, shift, activation, mask) is fused, with the
//   activation a template argument, and each result goes out in one 16-byte
//   store.
// - The tile shapes are chosen per shape class by ops/fused_depthwise.py
//   plan(): wide spatial tiles over all channels for narrow, large images,
//   whole small images over a channel chunk for wide ones, and smaller tiles
//   where a batch is too small to fill the 132 SMs.
// - x and y may be channel slices of wider NHWC tensors (a pixel pitch above
//   C), so AtomNAS branches read and write their slices in place.
// - Channel counts, pitches or pointers that do not allow 16-byte access
//   take a scalar path with the same tiling (VEC = 1, staged as float).
//
// Measured (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3 at a 700 W power
// limit, the 15 depthwise stages of MobileNetV3-Large at batch 32, f32,
// summed): 0.236 ms on the device alone and 0.315 ms cold (L2 flushed)
// against 0.429 and 0.514 ms for F.conv2d(groups=C, bias) and a 0.144 ms
// bound, 46% of it cold; back to back, where the wrapper's 20 us of host
// work per launch paces the small stages, 0.411 ms against 0.501 ms. The
// one-thread-per-output kernel took 1.24 ms on the device alone and 1.32
// ms cold.
// PERF.md has the stages one by one, bf16, and what holds each back.
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

constexpr int kMaxThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;  // above this a launch needs the attribute

__device__ __forceinline__ float relu6f(float v) { return fminf(fmaxf(v, 0.0f), 6.0f); }

// stable in both directions: exp of a non-positive argument only
__device__ __forceinline__ float sigmoidf(float v) {
  if (v >= 0.0f) {
    return 1.0f / (1.0f + expf(-v));
  }
  float e = expf(v);
  return e / (1.0f + e);
}

// same formulas and operation order as ops/activations.py; a template so
// that the epilogue's loop has no branch on the activation
template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == kRelu) {
    return fmaxf(v, 0.0f);
  } else if constexpr (ACT == kRelu6) {
    return relu6f(v);
  } else if constexpr (ACT == kHswish) {
    return v * relu6f(v + 3.0f) * (1.0f / 6.0f);
  } else if constexpr (ACT == kHsigmoid) {
    return relu6f(v + 3.0f) * (1.0f / 6.0f);
  } else if constexpr (ACT == kSwish) {
    return v * sigmoidf(v);
  } else if constexpr (ACT == kSigmoid) {
    return sigmoidf(v);
  } else {
    return v;
  }
}

// output columns per thread: 8 for f32 vectors and the scalar path, 4 for
// bf16 vectors (8 channels each), so a thread holds 32 sums (ops/
// fused_depthwise.py strip_width)
__host__ __device__ constexpr int strip_width(int vec) { return vec == 8 ? 4 : 8; }

// what a block stages in shared memory: x's own type on the vector path
// (raw 16-byte copies), float on the scalar path
template <typename T, int VEC>
struct Staged {
  using type = T;
};
template <typename T>
struct Staged<T, 1> {
  using type = float;
};

struct Params {
  const void* x;
  const float* w;
  const float* scale;
  const float* shift;
  const float* mask;
  void* y;
  int n, h, wd, c, oh, ow, k, stride, act;
  int x_pitch, y_pitch;         // elements from one pixel to the next in x and y
  int th, tw, cb;               // output tile: th x tw pixels by cb channels
  int tiles_h, tiles_w, chunks; // tiles per image column, row and channel axis
  int ih, iw;                   // input tile with its halo: ih x iw pixels
  int row_pitch;                // staged elements from one input row to the next
  int param_vec;                // floats per copy of the taps, scale, shift and mask: 4 or 1
  int pad;                      // staged elements after each group of R*s columns
  int in_bytes;                 // bytes of the staged input tile (a multiple of 16)
};

// VEC consecutive float32 values from shared memory (16-byte aligned when VEC > 1)
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = *p;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + e);
      v[e] = f.x;
      v[e + 1] = f.y;
      v[e + 2] = f.z;
      v[e + 3] = f.w;
    }
  }
}

template <int VEC>
__device__ __forceinline__ void load_staged(const float* p, float (&v)[VEC]) {
  load_f32<VEC>(p, v);
}

// 8 bf16 channels in one 16-byte load; bf16 -> f32 is exact (the high half)
__device__ __forceinline__ void load_staged(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = __uint_as_float(words[e] << 16);
    v[2 * e + 1] = __uint_as_float(words[e] & 0xffff0000u);
  }
}

template <int VEC>
__device__ __forceinline__ void store_out(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = v[0];
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float (&v)[1]) { *p = __float2bfloat16(v[0]); }

__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                            pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

// 16-byte asynchronous copy global -> shared; fill = false copies nothing
// from src and writes 16 zero bytes (the zero pad). A miss fetches the
// whole 128-byte line into L2 (scripts/split_fused_depthwise.py times the
// kernel without the hint; PERF.md)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int src_bytes = fill ? 16 : 0;
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
               : "memory");
}

// the same for 4 bytes (.ca: only 16-byte copies may skip L1)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int src_bytes = fill ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// acc[r] += sum_{i,j} in[i, r*s + j] * taps[i, j] for the R columns of one
// strip. `in` points at the strip's first input of its first tap row; the
// staged tile has row_pitch elements a row, cb a pixel and pad more after
// each group of R*s columns (the plan's layout). K and S are compile-time (0:
// runtime k and s).
template <int VEC, int K, int S, int R, typename SE>
__device__ __forceinline__ void accumulate(float (&acc)[R][VEC], const SE* in, const float* taps, int k, int s,
                                           int row_pitch, int cb, int pad) {
  if constexpr (K > 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float t[K][VEC];
#pragma unroll
      for (int j = 0; j < K; ++j) load_f32<VEC>(taps + (i * K + j) * cb, t[j]);
#pragma unroll
      for (int q = 0; q < (R - 1) * S + K; ++q) {
        float v[VEC];
        load_staged(in + i * row_pitch + q * cb + (q / (R * S)) * pad, v);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = q - r * S;
          if (j >= 0 && j < K) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(v[e], t[j][e], acc[r][e]);
          }
        }
      }
    }
  } else {
    for (int i = 0; i < k; ++i) {
      for (int q = 0; q < (R - 1) * s + k; ++q) {
        float v[VEC];
        load_staged(in + i * row_pitch + q * cb + (q / (R * s)) * pad, v);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = q - r * s;
          if (j >= 0 && j < k) {
            float t[VEC];
            load_f32<VEC>(taps + (i * k + j) * cb, t);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(v[e], t[e], acc[r][e]);
          }
        }
      }
    }
  }
}

// the fused epilogue of one strip: act(acc * scale + shift) * mask for its
// first `cols` columns, one 16-byte store (or one scalar) per column
template <int ACT, typename T, int VEC, int R>
__device__ __forceinline__ void store_strip(T* out, int pitch, int cols, const float (&acc)[R][VEC],
                                            const float (&sc)[VEC], const float (&sh)[VEC], const float (&mk)[VEC]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < cols) {
      float v[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = activate<ACT>(acc[r][e] * sc[e] + sh[e]) * mk[e];
      store_out(out + r * pitch, v);
    }
  }
}

template <typename T, int VEC, int K, int S>
__global__ void __launch_bounds__(kMaxThreads) fused_dw_kernel(const Params p) {
  using SE = typename Staged<T, VEC>::type;
  constexpr int R = strip_width(VEC);
  const int k = K > 0 ? K : p.k;
  const int s = S > 0 ? S : p.stride;
  const int group = R * s;  // columns between two strips (a shift when s is compile-time)
  extern __shared__ __align__(16) unsigned char smem[];
  SE* s_in = reinterpret_cast<SE*>(smem);
  float* s_w = reinterpret_cast<float*>(smem + p.in_bytes);
  float* s_scale = s_w + k * k * p.cb;
  float* s_shift = s_scale + p.cb;
  float* s_mask = s_shift + p.cb;

  // the block's tile, decoded once: channel chunk fastest, so the blocks of
  // one spatial tile run together and share its halo rows in L2
  unsigned b = blockIdx.x;
  const int chunk = b % p.chunks;
  b /= p.chunks;
  const int tx = b % p.tiles_w;
  b /= p.tiles_w;
  const int ty = b % p.tiles_h;
  const int img = b / p.tiles_h;
  const int c0 = chunk * p.cb;
  const int oy0 = ty * p.th;
  const int ox0 = tx * p.tw;
  const int iy0 = oy0 * s - k / 2;
  const int ix0 = ox0 * s - k / 2;
  const int nvec = p.cb / VEC;  // channel vectors in the chunk

  // 1. the input tile with its halo, zero outside the image and past C.
  // Thread t stages vectors t, t + blockDim.x, ... of the tile in (row,
  // column, channel vector) order; the step is decoded once and each
  // vector's indices follow by carries, with no divide in the loop.
  const T* xb = static_cast<const T*>(p.x) + (int64_t)img * p.h * p.wd * p.x_pitch + c0;
  {
    int cv = threadIdx.x % nvec;
    int col = threadIdx.x / nvec;
    int row = col / p.iw;
    col -= row * p.iw;
    const int step_cv = blockDim.x % nvec;
    int step_col = blockDim.x / nvec;
    const int step_row = step_col / p.iw;
    step_col -= step_row * p.iw;
    while (row < p.ih) {
      const int iy = iy0 + row;
      const int ix = ix0 + col;
      const bool inside = iy >= 0 && iy < p.h && ix >= 0 && ix < p.wd && c0 + cv * VEC < p.c;
      const T* src = xb + (inside ? (iy * p.wd + ix) * p.x_pitch + cv * VEC : 0);
      SE* dst = s_in + row * p.row_pitch + col * p.cb + (col / group) * p.pad + cv * VEC;
      if constexpr (VEC > 1) {
        cp_async16(dst, src, inside);
      } else if constexpr (sizeof(T) == 4) {
        cp_async4(dst, src, inside);
      } else {
        *dst = inside ? __bfloat162float(*src) : 0.0f;  // bf16 is staged as float
      }
      cv += step_cv;
      col += step_col;
      row += step_row;
      if (cv >= nvec) {
        cv -= nvec;
        ++col;
      }
      if (col >= p.iw) {
        col -= p.iw;
        ++row;
      }
    }
  }
  // 2. taps, scale, shift and mask, copied asynchronously as well, so that
  // their latency overlaps the input's: the (k*k + 3) rows of cb floats lie
  // contiguous in shared memory, taken pv floats a copy (4 where C and the
  // pointers allow 16 bytes, else 1), indices again by carries
  {
    const int pv = p.param_vec;
    const int per_row = p.cb / pv;
    int u = threadIdx.x % per_row;
    int row = threadIdx.x / per_row;
    const int step_u = blockDim.x % per_row;
    const int step_row = blockDim.x / per_row;
    while (row < k * k + 3) {
      const int ch = c0 + u * pv;
      const float* base = row < k * k       ? p.w + row * p.c
                          : row == k * k     ? p.scale
                          : row == k * k + 1 ? p.shift
                                             : p.mask;
      const bool inside = ch < p.c;
      const float* src = inside ? base + ch : p.w;
      float* dst = s_w + row * p.cb + u * pv;
      if (pv == 4) {
        cp_async16(dst, src, inside);
      } else {
        cp_async4(dst, src, inside);
      }
      u += step_u;
      row += step_row;
      if (u >= per_row) {
        u -= per_row;
        ++row;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. each item: R consecutive output columns of one row, VEC channels
  const int strips = p.tw / R;
  const int items = p.th * strips * nvec;
  T* yb = static_cast<T*>(p.y) + (int64_t)img * p.oh * p.ow * p.y_pitch + c0;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int cv = it % nvec;
    const int rest = it / nvec;
    const int strip = rest % strips;
    const int row = rest / strips;
    const int oy = oy0 + row;
    const int ox = ox0 + strip * R;
    if (oy >= p.oh || ox >= p.ow || c0 + cv * VEC >= p.c) continue;
    float acc[R][VEC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] = 0.0f;
    }
    accumulate<VEC, K, S, R>(acc, s_in + row * s * p.row_pitch + strip * (group * p.cb + p.pad) + cv * VEC,
                             s_w + cv * VEC, k, s, p.row_pitch, p.cb, p.pad);
    // 4. the fused epilogue and one 16-byte store per output pixel
    float sc[VEC], sh[VEC], mk[VEC];
    load_f32<VEC>(s_scale + cv * VEC, sc);
    load_f32<VEC>(s_shift + cv * VEC, sh);
    load_f32<VEC>(s_mask + cv * VEC, mk);
    const int cols = p.ow - ox < R ? p.ow - ox : R;
    T* out = yb + (oy * p.ow + ox) * p.y_pitch + cv * VEC;
    switch (p.act) {
      case kRelu: store_strip<kRelu>(out, p.y_pitch, cols, acc, sc, sh, mk); break;
      case kRelu6: store_strip<kRelu6>(out, p.y_pitch, cols, acc, sc, sh, mk); break;
      case kHswish: store_strip<kHswish>(out, p.y_pitch, cols, acc, sc, sh, mk); break;
      case kHsigmoid: store_strip<kHsigmoid>(out, p.y_pitch, cols, acc, sc, sh, mk); break;
      case kSwish: store_strip<kSwish>(out, p.y_pitch, cols, acc, sc, sh, mk); break;
      case kSigmoid: store_strip<kSigmoid>(out, p.y_pitch, cols, acc, sc, sh, mk); break;
      default: store_strip<kIdentity>(out, p.y_pitch, cols, acc, sc, sh, mk); break;
    }
  }
}

template <typename T, int VEC, int K, int S>
cudaError_t launch_tiled(const Params& p, unsigned blocks, int threads, int smem, cudaStream_t stream) {
  auto kernel = fused_dw_kernel<T, VEC, K, S>;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// compile-time k and stride for the shapes of the model zoo, runtime for
// any other odd k and stride
template <typename T, int VEC>
cudaError_t dispatch(const Params& p, unsigned blocks, int threads, int smem, cudaStream_t stream) {
  if (p.stride == 1) {
    switch (p.k) {
      case 3: return launch_tiled<T, VEC, 3, 1>(p, blocks, threads, smem, stream);
      case 5: return launch_tiled<T, VEC, 5, 1>(p, blocks, threads, smem, stream);
      case 7: return launch_tiled<T, VEC, 7, 1>(p, blocks, threads, smem, stream);
      default: break;
    }
  } else if (p.stride == 2) {
    switch (p.k) {
      case 3: return launch_tiled<T, VEC, 3, 2>(p, blocks, threads, smem, stream);
      case 5: return launch_tiled<T, VEC, 5, 2>(p, blocks, threads, smem, stream);
      case 7: return launch_tiled<T, VEC, 7, 2>(p, blocks, threads, smem, stream);
      default: break;
    }
  }
  return launch_tiled<T, VEC, 0, 0>(p, blocks, threads, smem, stream);
}

}  // namespace

extern "C" {

// x, w, scale, shift, mask and y are device pointers on `device`; w (k,k,C),
// scale, shift and mask (C,) are contiguous float32. args holds, in this
// order, the integers device, n, h, wd, c, k, stride, act, dtype, x_pitch,
// y_pitch, th, tw, cb, threads, vec, smem_bytes, pad, row_pitch (one host
// array, made once per shape by ops/fused_depthwise.py, so that the call
// converts no integer). The launch makes `device` current and restores the
// caller's device after. dtype: 0 = float32, 1 = bfloat16 (x and y). x is (n, h, wd)
// pixels of C channels x_pitch elements apart, y the same with y_pitch: a
// contiguous NHWC tensor has pitch C, a channel slice of a wider one the
// wider C (its pointer already offset to the slice). The tiling (th, tw,
// cb, threads, vec) and the staged tile's layout (pad elements after each
// group of strip columns, row_pitch elements a row) come from
// ops/fused_depthwise.py plan(); smem_bytes is what the plan declares, at
// least what that tile needs. vec: 1 (scalar) or 16 bytes of x's type (4
// float32, 8 bfloat16), which needs C, both pitches and both pointers
// aligned to it. The launch goes on `stream` and does not synchronize.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for operands the kernel does not take.
int yamt_fused_depthwise(const void* x, const void* w, const void* scale, const void* shift, const void* mask,
                         void* y, const int* args, void* stream) {
  const int device = args[0], n = args[1], h = args[2], wd = args[3], c = args[4], k = args[5], stride = args[6],
            act = args[7], dtype = args[8], x_pitch = args[9], y_pitch = args[10], th = args[11], tw = args[12],
            cb = args[13], threads = args[14], vec = args[15], smem_bytes = args[16], pad = args[17],
            row_pitch = args[18];
  const int itemsize = dtype == 0 ? 4 : 2;
  if (device < 0 || n < 0 || h < 1 || wd < 1 || c < 1 || k < 1 || (k % 2) == 0 || stride < 1 || act < 0 || act > kSigmoid ||
      (dtype != 0 && dtype != 1) || x_pitch < c || y_pitch < c || th < 1 || tw < 1 || cb < 1 || threads < 32 ||
      threads > kMaxThreads || (vec != 1 && vec != 16 / itemsize)) {
    return (int)cudaErrorInvalidValue;
  }
  const int r = strip_width(vec);
  if (tw % r != 0 || cb % vec != 0) return (int)cudaErrorInvalidValue;
  if (vec > 1 && (c % vec != 0 || x_pitch % vec != 0 || y_pitch % vec != 0 ||
                  reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.x = x;
  p.w = static_cast<const float*>(w);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.mask = static_cast<const float*>(mask);
  p.y = y;
  p.n = n;
  p.h = h;
  p.wd = wd;
  p.c = c;
  p.oh = (h - 1) / stride + 1;
  p.ow = (wd - 1) / stride + 1;
  p.k = k;
  p.stride = stride;
  p.act = act;
  p.x_pitch = x_pitch;
  p.y_pitch = y_pitch;
  p.th = th;
  p.tw = tw;
  p.cb = cb;
  p.tiles_h = (p.oh + th - 1) / th;
  p.tiles_w = (p.ow + tw - 1) / tw;
  p.chunks = (c + cb - 1) / cb;
  p.ih = (th - 1) * stride + k;
  p.iw = (tw - 1) * stride + k;
  p.pad = pad;
  p.row_pitch = row_pitch;
  // the layout must hold every staged element of a row (the last pixel of
  // a row ends at iw*cb plus a pad per whole group of columns before it)
  // and keep each 16-byte vector aligned
  if (pad < 0 || pad % vec != 0 || row_pitch % vec != 0 ||
      (int64_t)row_pitch < (int64_t)p.iw * cb + (int64_t)((p.iw - 1) / (r * stride)) * pad) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t staged_bytes = (int64_t)p.ih * row_pitch * (vec > 1 ? itemsize : 4);
  const int64_t need = staged_bytes + (int64_t)(k * k + 3) * cb * 4;
  if (need > smem_bytes) return (int)cudaErrorInvalidValue;
  p.in_bytes = (int)staged_bytes;
  const bool params_aligned = (reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(scale) |
                               reinterpret_cast<uintptr_t>(shift) | reinterpret_cast<uintptr_t>(mask)) % 16 == 0;
  p.param_vec = c % 4 == 0 && cb % 4 == 0 && params_aligned && staged_bytes % 16 == 0 ? 4 : 1;
  const int64_t blocks = (int64_t)n * p.tiles_h * p.tiles_w * p.chunks;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0) {
    err = vec > 1 ? dispatch<float, 4>(p, (unsigned)blocks, threads, smem_bytes, s)
                  : dispatch<float, 1>(p, (unsigned)blocks, threads, smem_bytes, s);
  } else {
    err = vec > 1 ? dispatch<__nv_bfloat16, 8>(p, (unsigned)blocks, threads, smem_bytes, s)
                  : dispatch<__nv_bfloat16, 1>(p, (unsigned)blocks, threads, smem_bytes, s);
  }
  if (prev != device) {
    const cudaError_t restored = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restored;
  }
  return (int)err;
}

const char* yamt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
