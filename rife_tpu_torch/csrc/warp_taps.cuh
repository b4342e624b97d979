// What the warp kernels share: typed loads and stores, and the sampling
// coordinate, tap indices and bilinear weights of one output pixel.
//
// Included by warp_planes.cu (K1's forward), warp_blend.cu (K2),
// warp_nhwc.cu (K3, K4) and gather_probe.cu (K6c), so that K2's two warped
// images and the NHWC warps are K1's outputs bit for bit, and by
// warp_planes_bwd.cu for the loads and stores.  K1 and K2 share the run
// accesses (load_run, store_run).  Semantics (rife_tpu's
// warp_xla_planes): the pixel (x, y) samples at (clamp(x + dx, 0, W-1),
// clamp(y + dy, 0, H-1)) with x1 = min(x0+1, W-1), y1 = min(y0+1, H-1);
// coordinates are f32 even for a bf16 flow.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// A pixel's flow pair (dx, dy): one 8-byte (f32) or 4-byte (bf16) load
// where VEC (the caller has checked that the pair's address is a multiple
// of its size), else two scalar loads.
template <bool VEC>
__device__ __forceinline__ void load_pair(const float* p, float& dx, float& dy) {
  if (VEC) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    dx = v.x;
    dy = v.y;
  } else {
    dx = __ldg(p);
    dy = __ldg(p + 1);
  }
}
template <bool VEC>
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& dx, float& dy) {
  if (VEC) {
    const float2 v = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
    dx = v.x;
    dy = v.y;
  } else {
    dx = load_f(p);
    dy = load_f(p + 1);
  }
}

// 16 bytes of T as V floats: one load through the read-only path, one
// store (the address a multiple of 16 bytes).
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

// N consecutive values of T, a thread's run of one plane's row, as one
// access of N x sizeof(T) bytes (4, 8 or 16; the address a multiple of
// it, which the wrappers check).  load_run reads them as floats and
// store_run writes them back, a bf16 value rounded to nearest as store_f
// does.
template <int BYTES>
struct Chunk;
template <>
struct Chunk<4> {
  using type = unsigned int;
};
template <>
struct Chunk<8> {
  using type = uint2;
};
template <>
struct Chunk<16> {
  using type = uint4;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float& e, float v) { e = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16& e, float v) { e = __float2bfloat16(v); }

template <int N, typename T>
__device__ __forceinline__ void load_run(const T* p, float* v) {
  using U = typename Chunk<N * sizeof(T)>::type;
  const U q = __ldg(reinterpret_cast<const U*>(p));
  const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = to_f(e[j]);
}

template <int N, typename T>
__device__ __forceinline__ void store_run(T* p, const float* v) {
  using U = typename Chunk<N * sizeof(T)>::type;
  U q;
  T* e = reinterpret_cast<T*>(&q);
#pragma unroll
  for (int j = 0; j < N; ++j) from_f(e[j], v[j]);
  *reinterpret_cast<U*>(p) = q;
}

// v rounded to T and back: what storing v as a T and reading it back gives.
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// The sampling position of one output pixel: its tap columns x0, x1 and
// rows y0, y1, the weights' fractions and their complements 1 - f.
struct Coords {
  int x0, x1, y0, y1;
  float fx, fy, gx, gy;
};

__device__ __forceinline__ Coords coords_at(int x, int y, float dx, float dy,
                                            int H, int W) {
  const float ix = fminf(fmaxf((float)x + dx, 0.0f), (float)(W - 1));
  const float iy = fminf(fmaxf((float)y + dy, 0.0f), (float)(H - 1));
  const float x0f = floorf(ix);
  const float y0f = floorf(iy);
  Coords k;
  k.x0 = (int)x0f;
  k.y0 = (int)y0f;
  k.x1 = min(k.x0 + 1, W - 1);
  k.y1 = min(k.y0 + 1, H - 1);
  k.fx = ix - x0f;
  k.fy = iy - y0f;
  k.gx = 1.0f - k.fx;
  k.gy = 1.0f - k.fy;
  return k;
}

// The four flat tap indices of one output pixel of a plane and its weights.
struct Taps {
  int64_t i00, i01, i10, i11;
  float fx, fy, gx, gy;  // fractions and their complements 1 - f
};

__device__ __forceinline__ Taps taps_at(int x, int y, float dx, float dy,
                                        int H, int W) {
  const Coords k = coords_at(x, y, dx, dy, H, W);
  Taps t;
  t.i00 = (int64_t)k.y0 * W + k.x0;
  t.i01 = (int64_t)k.y0 * W + k.x1;
  t.i10 = (int64_t)k.y1 * W + k.x0;
  t.i11 = (int64_t)k.y1 * W + k.x1;
  t.fx = k.fx;
  t.fy = k.fy;
  t.gx = k.gx;
  t.gy = k.gy;
  return t;
}

// The bilinear blend of four taps, in f32.  The plain version's operations
// in its order, each rounded on its own (the _rn intrinsics are never
// contracted into an FMA), so the kernels give the plain version's f32
// result bit for bit.  A contracted FMA would differ by an f32 rounding,
// which where the taps cancel is more than one bf16 ulp of the small
// result.
__device__ __forceinline__ float blend4(float v00, float v01, float v10,
                                        float v11, float fx, float fy,
                                        float gx, float gy) {
  const float top = __fadd_rn(__fmul_rn(v00, gx), __fmul_rn(v01, fx));
  const float bot = __fadd_rn(__fmul_rn(v10, gx), __fmul_rn(v11, fx));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
}

// The bilinear blend of one plane's four taps.
template <typename T>
__device__ __forceinline__ float bilerp(const T* src, const Taps& t) {
  return blend4(load_f(src + t.i00), load_f(src + t.i01), load_f(src + t.i10),
                load_f(src + t.i11), t.fx, t.fy, t.gx, t.gy);
}

}  // namespace
