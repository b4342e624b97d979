// Fused pair warp + sigmoid-mask blend of (N, C, H, W) planes: the final
// level of the frame-interpolation models.
//
// Replaces the TPU kernel rife_tpu/ops/pallas/warp_blend.py:warp_pair_blend_pl
// (kernel _warp_blend_kernel).  For img0, img1 (N, C, H, W), a pair flow
// (N, 4, H, W) ([:, 0:2] warps img0, [:, 2:4] img1) and a pre-sigmoid mask
// (N, 1, H, W):
//
//   w0 = warp(img0, flow[:, 0:2]),  w1 = warp(img1, flow[:, 2:4])
//   blend = w0 * sigmoid(mask) + w1 * (1 - sigmoid(mask))
//
// Value chain: w0 and w1 are K1's bilinear results (the same tap code,
// warp_taps.cuh), each rounded once to the image's type; sigmoid is taken
// in f32 and rounded to the image's type; the blend is
// f32(w0) * s + f32(w1) * (1 - s) in f32, each operation rounded on its own
// as the plain version does it, and rounded once to the image's type.  An
// f32 image therefore stays f32 throughout (the TPU kernel always emitted
// bf16).  PAIR also writes w0 and w1 (the paper model's U-Net reads them);
// otherwise only the blend is written (v4.25).
//
// Bound: bytes.  A launch must read both images, the flow and the mask
// once and write the blend (and w0, w1) once; it does about 25 flops per
// output element, far below the card's ratio of operations to bytes.  The
// TPU kernel's windows, scalar prefetch and packed taps are not carried
// over: each thread gathers its taps straight from device memory through
// the read-only path, so the warp is exact for every flow, and L1 and L2
// absorb the four-fold tap re-reads.
//
// The design (K1's run layout, warp_planes.cu, in smaller blocks; the
// wrapper's k2_plan in ops/cuda/warp_blend.py computes the launch, so the
// CPU tests hold its arithmetic): a grid of (row tile, row block, image)
// blocks of (tx, ty) threads, tx <= 32 and 64 threads a block (at 1280
// wide: 32 x 2), no division; a thread takes PPT consecutive pixels of a row,
// reads their four flow runs and their mask run, computes both images'
// coordinates, 32-bit tap offsets and weights and the sigmoid once per
// pixel, then for each channel (the loop unrolled for C = 3, read at run
// time otherwise) takes the plane's 64-bit base once, gathers 4 taps of
// each image per pixel and writes the blend run (and the w0 and w1 runs).
// The flow, mask and output runs go as one access of PPT values where the
// row's width and the addresses allow it (VEC: 4 bytes a run in bf16, 8
// in f32); else value by value.  Measured on an H100 at the serving
// launches (tools/warp_blend.py, PERF.md): runs of 4, which hoist twice
// the taps into registers, took a third longer in the blend-only form
// (2-3% less in the pair form); blocks of 64 threads (32 x 2) took 10-14%
// less than K1's 160 x 1 and up to 14% less than 32 x 8; capping the
// registers with launch bounds, or keeping the channel loop rolled, was
// slower.

#include "warp_taps.cuh"

namespace {

// Pixels a thread; the wrapper's K2_PPT.  A variant build sets another
// (-DK2_PPT=4) to measure it; the shipped library takes only this one.
#ifndef K2_PPT
#define K2_PPT 2
#endif
constexpr int PPT = K2_PPT;
constexpr int MAX_THREADS = 256;

// PAIR (emit_pair) and VEC are template parameters, not tests in the loop;
// CT = C, or 0 to read C at run time.
template <typename T, typename F, typename M, bool PAIR, bool VEC, int CT>
__global__ void __launch_bounds__(MAX_THREADS)
warp_blend_kernel(const T* __restrict__ img0, const T* __restrict__ img1,
                  const F* __restrict__ flow, const M* __restrict__ mask,
                  T* __restrict__ blend, T* __restrict__ w0,
                  T* __restrict__ w1, int C, int H, int W) {
  const int xb = (blockIdx.x * blockDim.x + threadIdx.x) * PPT;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (xb >= W || y >= H) return;
  const int n = blockIdx.z;
  const int64_t hw = (int64_t)H * W;
  const int row = y * W;

  const F* fl = flow + 4 * n * hw + row;
  const M* mk = mask + n * hw + row;
  float dx0[PPT], dy0[PPT], dx1[PPT], dy1[PPT], m[PPT];
  if (VEC) {
    load_run<PPT>(fl + xb, dx0);
    load_run<PPT>(fl + hw + xb, dy0);
    load_run<PPT>(fl + 2 * hw + xb, dx1);
    load_run<PPT>(fl + 3 * hw + xb, dy1);
    load_run<PPT>(mk + xb, m);
  } else {
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      // A pixel past the row's end repeats the row's last and stores nothing.
      const int x = min(xb + j, W - 1);
      dx0[j] = load_f(fl + x);
      dy0[j] = load_f(fl + hw + x);
      dx1[j] = load_f(fl + 2 * hw + x);
      dy1[j] = load_f(fl + 3 * hw + x);
      m[j] = load_f(mk + x);
    }
  }
  // Per pixel and image: the four tap offsets within a plane and the weights.
  int a00[2][PPT], a01[2][PPT], a10[2][PPT], a11[2][PPT];
  float fx[2][PPT], fy[2][PPT], gx[2][PPT], gy[2][PPT];
  float s[PPT], s1[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int x = min(xb + j, W - 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const Coords k = coords_at(x, y, i ? dx1[j] : dx0[j], i ? dy1[j] : dy0[j], H, W);
      const int r0 = k.y0 * W, r1 = k.y1 * W;
      a00[i][j] = r0 + k.x0;
      a01[i][j] = r0 + k.x1;
      a10[i][j] = r1 + k.x0;
      a11[i][j] = r1 + k.x1;
      fx[i][j] = k.fx;
      fy[i][j] = k.fy;
      gx[i][j] = k.gx;
      gy[i][j] = k.gy;
    }
    s[j] = round_as(1.0f / (1.0f + expf(-m[j])), blend);
    s1[j] = __fsub_rn(1.0f, s[j]);
  }
  const int64_t plane = (int64_t)n * C * hw;
  const T* src0 = img0 + plane;
  const T* src1 = img1 + plane;
  const int64_t at = plane + row + xb;
  T* ob = blend + at;
  T* o0 = PAIR ? w0 + at : nullptr;
  T* o1 = PAIR ? w1 + at : nullptr;
  auto one_channel = [&]() {
    float v0[PPT], v1[PPT], vb[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      v0[j] = round_as(blend4(load_f(src0 + a00[0][j]), load_f(src0 + a01[0][j]),
                              load_f(src0 + a10[0][j]), load_f(src0 + a11[0][j]),
                              fx[0][j], fy[0][j], gx[0][j], gy[0][j]),
                       blend);
      v1[j] = round_as(blend4(load_f(src1 + a00[1][j]), load_f(src1 + a01[1][j]),
                              load_f(src1 + a10[1][j]), load_f(src1 + a11[1][j]),
                              fx[1][j], fy[1][j], gx[1][j], gy[1][j]),
                       blend);
      vb[j] = __fadd_rn(__fmul_rn(v0[j], s[j]), __fmul_rn(v1[j], s1[j]));
    }
    if (VEC) {
      store_run<PPT>(ob, vb);
      if (PAIR) {
        store_run<PPT>(o0, v0);
        store_run<PPT>(o1, v1);
      }
    } else {
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        if (xb + j < W) {
          store_f(ob + j, vb[j]);
          if (PAIR) {
            store_f(o0 + j, v0[j]);
            store_f(o1 + j, v1[j]);
          }
        }
      }
    }
    src0 += hw;
    src1 += hw;
    ob += hw;
    if (PAIR) {
      o0 += hw;
      o1 += hw;
    }
  };
  if (CT > 0) {
#pragma unroll
    for (int c = 0; c < CT; ++c) one_channel();
  } else {
    for (int c = 0; c < C; ++c) one_channel();
  }
}

template <typename T, typename F, typename M, bool PAIR, bool VEC>
void launch_c(const void* img0, const void* img1, const void* flow, const void* mask,
              void* blend, void* w0, void* w1, int C, int H, int W, dim3 grid,
              dim3 block, cudaStream_t s) {
  const auto* a = static_cast<const T*>(img0);
  const auto* b = static_cast<const T*>(img1);
  const auto* f = static_cast<const F*>(flow);
  const auto* m = static_cast<const M*>(mask);
  auto* o = static_cast<T*>(blend);
  auto* p0 = static_cast<T*>(w0);
  auto* p1 = static_cast<T*>(w1);
  if (C == 3) {
    warp_blend_kernel<T, F, M, PAIR, VEC, 3><<<grid, block, 0, s>>>(a, b, f, m, o, p0, p1,
                                                                      C, H, W);
  } else {
    warp_blend_kernel<T, F, M, PAIR, VEC, 0><<<grid, block, 0, s>>>(a, b, f, m, o, p0, p1,
                                                                      C, H, W);
  }
}

template <typename T, typename F, typename M>
void launch_typed(const void* img0, const void* img1, const void* flow, const void* mask,
                  void* blend, void* w0, void* w1, int C, int H, int W, int vec,
                  dim3 grid, dim3 block, cudaStream_t s) {
  if (w0 != nullptr) {
    if (vec)
      launch_c<T, F, M, true, true>(img0, img1, flow, mask, blend, w0, w1, C, H, W, grid,
                                    block, s);
    else
      launch_c<T, F, M, true, false>(img0, img1, flow, mask, blend, w0, w1, C, H, W, grid,
                                     block, s);
  } else {
    if (vec)
      launch_c<T, F, M, false, true>(img0, img1, flow, mask, blend, nullptr, nullptr, C, H,
                                     W, grid, block, s);
    else
      launch_c<T, F, M, false, false>(img0, img1, flow, mask, blend, nullptr, nullptr, C,
                                      H, W, grid, block, s);
  }
}

template <typename T>
int launch(const void* img0, const void* img1, const void* flow, const void* mask,
           void* blend, void* w0, void* w1, int N, int C, int H, int W, int flow_is_bf16,
           int mask_is_bf16, int gx, int gy, int tx, int ty, int ppt, int vec,
           void* stream) {
  // A launch that would leave pixels unwritten, or that the grid cannot
  // take, is refused.
  if (ppt != PPT || tx < 1 || ty < 1 || tx * ty > MAX_THREADS || gx < 1 || gy < 1 ||
      gy > 65535 || N < 1 || N > 65535 || C < 1 || (int64_t)gx * tx * PPT < W ||
      (int64_t)gy * ty < H || (w0 == nullptr) != (w1 == nullptr) ||
      (vec && W % PPT != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(gx, gy, N), block(tx, ty);
  using BF = __nv_bfloat16;
  const int key = 2 * flow_is_bf16 + mask_is_bf16;
  if (key == 3)
    launch_typed<T, BF, BF>(img0, img1, flow, mask, blend, w0, w1, C, H, W, vec, grid,
                            block, s);
  else if (key == 2)
    launch_typed<T, BF, float>(img0, img1, flow, mask, blend, w0, w1, C, H, W, vec, grid,
                               block, s);
  else if (key == 1)
    launch_typed<T, float, BF>(img0, img1, flow, mask, blend, w0, w1, C, H, W, vec, grid,
                               block, s);
  else
    launch_typed<T, float, float>(img0, img1, flow, mask, blend, w0, w1, C, H, W, vec,
                                  grid, block, s);
  return (int)cudaGetLastError();
}

}  // namespace

// img0, img1, blend, w0, w1: (N, C, H, W) in the named type; flow
// (N, 4, H, W) and mask (N, 1, H, W) each f32 or bf16 (flow_is_bf16,
// mask_is_bf16); w0 and w1 both null for the blend-only form.  The launch
// from the wrapper (ops/cuda/warp_blend.py k2_plan): a grid of (gx, gy, N)
// blocks of (tx, ty) threads, `ppt` (this build's PPT) consecutive pixels
// a thread; `vec`: the flow, mask and output runs as single accesses (W a
// multiple of ppt, every such address a multiple of the run's bytes).
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a launch it
// does not take).
extern "C" int warp_blend_bf16(const void* img0, const void* img1, const void* flow,
                               const void* mask, void* blend, void* w0, void* w1, int N,
                               int C, int H, int W, int flow_is_bf16, int mask_is_bf16,
                               int gx, int gy, int tx, int ty, int ppt, int vec,
                               void* stream) {
  return launch<__nv_bfloat16>(img0, img1, flow, mask, blend, w0, w1, N, C, H, W,
                               flow_is_bf16, mask_is_bf16, gx, gy, tx, ty, ppt, vec, stream);
}

extern "C" int warp_blend_f32(const void* img0, const void* img1, const void* flow,
                              const void* mask, void* blend, void* w0, void* w1, int N,
                              int C, int H, int W, int flow_is_bf16, int mask_is_bf16,
                              int gx, int gy, int tx, int ty, int ppt, int vec,
                              void* stream) {
  return launch<float>(img0, img1, flow, mask, blend, w0, w1, N, C, H, W, flow_is_bf16,
                       mask_is_bf16, gx, gy, tx, ty, ppt, vec, stream);
}
