// Backward bilinear warp of NHWC images (N, H, W, C) by NHWC pixel flow
// (N, H, W, 2): the warp of the legacy models (hd, hdv2), whose images and
// context features are channels-last.
//
// Replaces the TPU kernels rife_tpu/ops/pallas/warp.py:warp_pallas (K3,
// kernel _warp_kernel; warp_pallas_auto sends it f32 images with C < 8) and
// rife_tpu/ops/pallas/warp_v4.py:warp_pallas_v4 (K4, kernel
// _warp_kernel_v4; f32 with C >= 8).  Semantics (rife_tpu/ops/warp.py
// warp_xla): out[n, y, x, c] samples channel c at
// (clamp(x + dx, 0, W-1), clamp(y + dy, 0, H-1)) with x1 = min(x0+1, W-1),
// y1 = min(y0+1, H-1); coordinates are f32 even for a bf16 flow.  The
// coordinate, tap and weight chain is K1's (warp_taps.cuh), so an NHWC
// warp is K1's warp of the permuted planes bit for bit.  A bf16 image
// gives bf16 taps with f32 weights and math, rounded once (rife_tpu's bf16
// NHWC route, warp_pallas_v5, which is K1 transposed); an f32 image stays
// f32 throughout.
//
// Strides: the image and the flow are read through element strides of
// their n, y and x axes; the channel stride must be 1.  So channel slices
// of a wider channels-last tensor (hd's x[..., :3], hdv2's pair flows) are
// read in place.  The output is a new contiguous (N, H, W, C) tensor.
//
// Bound: bytes.  A launch must read the image and the flow once and write
// the output once; it does 9 flops per output element.  The TPU kernels'
// windows, scalar prefetch and (8,128) tiles are not carried over: each
// thread gathers its taps straight from device memory, so the warp is
// exact for every flow, and L1 and L2 absorb the four-fold tap re-reads.
//
// - K3 (C < 8): one thread per output pixel; it reads the flow once,
//   computes the coordinate and weights once, and loops over the pixel's
//   C contiguous channels at each of the four taps.
// - K4 (C >= 8): one thread per (pixel, run of 16 bytes of channels: 4 f32
//   or 8 bf16), runs fastest, so the threads of one pixel read each tap's
//   whole channel vector together, one 16-byte load each.  Where the
//   channel count, the strides or the base address do not allow 16-byte
//   loads, the same thread layout loads its run channel by channel.

#include "warp_taps.cuh"

namespace {

constexpr int THREADS = 256;

struct Strides {
  int64_t n, y, x;  // element strides; the channel stride is 1
};

template <typename F>
__device__ __forceinline__ Coords coords_of(const F* flow, Strides fs, int n,
                                            int y, int x, int H, int W) {
  const F* f = flow + n * fs.n + y * fs.y + x * fs.x;
  return coords_at(x, y, load_f(f), load_f(f + 1), H, W);
}

// The four taps' first channels, from the image's base for batch n.
template <typename T>
struct TapPtrs {
  const T *p00, *p01, *p10, *p11;
};

template <typename T>
__device__ __forceinline__ TapPtrs<T> tap_ptrs(const T* src, Strides is,
                                               const Coords& k) {
  const T* r0 = src + k.y0 * is.y;
  const T* r1 = src + k.y1 * is.y;
  return {r0 + k.x0 * is.x, r0 + k.x1 * is.x, r1 + k.x0 * is.x,
          r1 + k.x1 * is.x};
}

template <typename T, typename F>
__global__ void __launch_bounds__(THREADS)
warp_nhwc_k3_kernel(const T* __restrict__ img, Strides is,
                    const F* __restrict__ flow, Strides fs,
                    T* __restrict__ out, int N, int H, int W, int C) {
  const int64_t hw = (int64_t)H * W;
  const int64_t p = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (p >= N * hw) return;
  const int n = (int)(p / hw);
  const int64_t r = p - n * hw;
  const int y = (int)(r / W);
  const int x = (int)(r - (int64_t)y * W);
  const Coords k = coords_of(flow, fs, n, y, x, H, W);
  const TapPtrs<T> t = tap_ptrs(img + n * is.n, is, k);
  T* dst = out + p * C;
  for (int c = 0; c < C; ++c) {
    store_f(dst + c, blend4(load_f(t.p00 + c), load_f(t.p01 + c),
                            load_f(t.p10 + c), load_f(t.p11 + c), k.fx, k.fy,
                            k.gx, k.gy));
  }
}

// 16 bytes of T as V floats.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

template <typename T, typename F, bool VEC>
__global__ void __launch_bounds__(THREADS)
warp_nhwc_k4_kernel(const T* __restrict__ img, Strides is,
                    const F* __restrict__ flow, Strides fs,
                    T* __restrict__ out, int N, int H, int W, int C, int runs) {
  constexpr int V = Vec<T>::V;
  const int64_t hw = (int64_t)H * W;
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= N * hw * runs) return;
  const int64_t p = i / runs;
  const int c0 = (int)(i - p * runs) * V;
  const int n = (int)(p / hw);
  const int64_t r = p - n * hw;
  const int y = (int)(r / W);
  const int x = (int)(r - (int64_t)y * W);
  const Coords k = coords_of(flow, fs, n, y, x, H, W);
  const TapPtrs<T> t = tap_ptrs(img + n * is.n + c0, is, k);
  T* dst = out + p * C + c0;
  if (VEC) {
    float v00[V], v01[V], v10[V], v11[V], o[V];
    Vec<T>::load(t.p00, v00);
    Vec<T>::load(t.p01, v01);
    Vec<T>::load(t.p10, v10);
    Vec<T>::load(t.p11, v11);
#pragma unroll
    for (int c = 0; c < V; ++c)
      o[c] = blend4(v00[c], v01[c], v10[c], v11[c], k.fx, k.fy, k.gx, k.gy);
    Vec<T>::store(dst, o);
  } else {
    const int cn = min(V, C - c0);
    for (int c = 0; c < cn; ++c) {
      store_f(dst + c, blend4(load_f(t.p00 + c), load_f(t.p01 + c),
                              load_f(t.p10 + c), load_f(t.p11 + c), k.fx,
                              k.fy, k.gx, k.gy));
    }
  }
}

unsigned blocks_for(int64_t threads) {
  return (unsigned)((threads + THREADS - 1) / THREADS);
}

template <typename T, typename F>
int launch_k3(const void* img, Strides is, const void* flow, Strides fs,
              void* out, int N, int H, int W, int C, cudaStream_t s) {
  warp_nhwc_k3_kernel<T, F><<<blocks_for((int64_t)N * H * W), THREADS, 0, s>>>(
      static_cast<const T*>(img), is, static_cast<const F*>(flow), fs,
      static_cast<T*>(out), N, H, W, C);
  return (int)cudaGetLastError();
}

template <typename T, typename F>
int launch_k4(const void* img, Strides is, const void* flow, Strides fs,
              void* out, int N, int H, int W, int C, int vec, cudaStream_t s) {
  constexpr int V = Vec<T>::V;
  const int runs = (C + V - 1) / V;
  const unsigned blocks = blocks_for((int64_t)N * H * W * runs);
  const T* im = static_cast<const T*>(img);
  const F* fl = static_cast<const F*>(flow);
  T* o = static_cast<T*>(out);
  if (vec) {
    warp_nhwc_k4_kernel<T, F, true><<<blocks, THREADS, 0, s>>>(
        im, is, fl, fs, o, N, H, W, C, runs);
  } else {
    warp_nhwc_k4_kernel<T, F, false><<<blocks, THREADS, 0, s>>>(
        im, is, fl, fs, o, N, H, W, C, runs);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The entry points: image strides (isn, isy, isx) and flow strides (fsn,
// fsy, fsx) in elements; out is a contiguous (N, H, W, C) tensor of the
// image's type.  `vec` (K4): 16-byte loads and stores, which the caller
// allows only where C, the image's strides and its address are multiples
// of 16 bytes.  Returns the launch's cudaError_t.
#define RIFE_NHWC_ENTRIES(SUFFIX, T)                                           \
  extern "C" int warp_nhwc_k3_##SUFFIX(                                        \
      const void* img, int64_t isn, int64_t isy, int64_t isx,                  \
      const void* flow, int64_t fsn, int64_t fsy, int64_t fsx, void* out,      \
      int N, int H, int W, int C, int flow_is_bf16, void* stream) {            \
    const Strides is{isn, isy, isx}, fs{fsn, fsy, fsx};                        \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                        \
    return flow_is_bf16                                                        \
               ? launch_k3<T, __nv_bfloat16>(img, is, flow, fs, out, N, H, W,  \
                                             C, s)                             \
               : launch_k3<T, float>(img, is, flow, fs, out, N, H, W, C, s);   \
  }                                                                            \
  extern "C" int warp_nhwc_k4_##SUFFIX(                                        \
      const void* img, int64_t isn, int64_t isy, int64_t isx,                  \
      const void* flow, int64_t fsn, int64_t fsy, int64_t fsx, void* out,      \
      int N, int H, int W, int C, int flow_is_bf16, int vec, void* stream) {   \
    const Strides is{isn, isy, isx}, fs{fsn, fsy, fsx};                        \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                        \
    return flow_is_bf16                                                        \
               ? launch_k4<T, __nv_bfloat16>(img, is, flow, fs, out, N, H, W,  \
                                             C, vec, s)                        \
               : launch_k4<T, float>(img, is, flow, fs, out, N, H, W, C, vec,  \
                                     s);                                       \
  }

RIFE_NHWC_ENTRIES(f32, float)
RIFE_NHWC_ENTRIES(bf16, __nv_bfloat16)
