// What the warp kernels share: typed loads and stores, and the sampling
// coordinate, tap indices and bilinear weights of one output pixel.
//
// Included by warp_planes.cu (K1's forward) and warp_blend.cu (K2), so
// that K2's two warped images are K1's outputs bit for bit, and by
// warp_planes_bwd.cu for the loads and stores.  Semantics (rife_tpu's
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

// v rounded to T and back: what storing v as a T and reading it back gives.
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// The four flat tap indices of one output pixel and its weights.
struct Taps {
  int64_t i00, i01, i10, i11;
  float fx, fy, gx, gy;  // fractions and their complements 1 - f
};

__device__ __forceinline__ Taps taps_at(int x, int y, float dx, float dy,
                                        int H, int W) {
  const float ix = fminf(fmaxf((float)x + dx, 0.0f), (float)(W - 1));
  const float iy = fminf(fmaxf((float)y + dy, 0.0f), (float)(H - 1));
  const float x0f = floorf(ix);
  const float y0f = floorf(iy);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  Taps t;
  t.i00 = (int64_t)y0 * W + x0;
  t.i01 = (int64_t)y0 * W + x1;
  t.i10 = (int64_t)y1 * W + x0;
  t.i11 = (int64_t)y1 * W + x1;
  t.fx = ix - x0f;
  t.fy = iy - y0f;
  t.gx = 1.0f - t.fx;
  t.gy = 1.0f - t.fy;
  return t;
}

// The bilinear blend of one plane's four taps, in f32.  The plain
// version's operations in its order, each rounded on its own (the _rn
// intrinsics are never contracted into an FMA), so the kernels give the
// plain version's f32 result bit for bit.  A contracted FMA would differ
// by an f32 rounding, which where the taps cancel is more than one bf16
// ulp of the small result.
template <typename T>
__device__ __forceinline__ float bilerp(const T* src, const Taps& t) {
  const float top = __fadd_rn(__fmul_rn(load_f(src + t.i00), t.gx),
                              __fmul_rn(load_f(src + t.i01), t.fx));
  const float bot = __fadd_rn(__fmul_rn(load_f(src + t.i10), t.gx),
                              __fmul_rn(load_f(src + t.i11), t.fx));
  return __fadd_rn(__fmul_rn(top, t.gy), __fmul_rn(bot, t.fy));
}

}  // namespace
