// Backward bilinear warp of (N, C, H, W) planes by (N, 2, H, W) pixel flow.
//
// Replaces the TPU kernel rife_tpu/ops/pallas/warp_v5.py:warp_pallas_v5_pl
// (kernel _warp_kernel_v5), forward only.  Semantics (rife_tpu/ops/warp.py
// warp_xla_planes): out[n, c, y, x] samples plane c at
// (clamp(x + dx, 0, W-1), clamp(y + dy, 0, H-1)) with x1 = min(x0+1, W-1),
// y1 = min(y0+1, H-1); coordinates are f32 even for a bf16 flow.  The blend
// is accumulated in f32 and stored in the image's type: a bf16 image gives
// bf16 taps with f32 math (as the TPU kernel does), an f32 image stays f32
// throughout (the TPU kernel would have rounded its taps to bf16).  The
// coordinate and the blend are warp_taps.cuh's, so K2, K3, K4 and K6c give
// this kernel's results bit for bit.
//
// Bound: bytes.  Each launch must read the image and the flow once and write
// the output once (2 B an element in bf16); it does 9 flops per output
// element, far below the card's ratio of operations to bytes.  The TPU
// kernel's 96-row windows, scalar prefetch, packed bf16 x-tap pairs and
// (8,128) tiles are not carried over: each thread gathers its taps straight
// from device memory through the read-only path, so the warp is exact for
// every flow, and L1 and L2 (50 MB, which holds a 720p bf16 plane) absorb
// the four-fold tap re-reads.
//
// The design (the wrapper's k1_plan in ops/cuda/warp.py computes the
// launch, so the CPU tests hold its arithmetic).  Offsets within a plane
// are 32-bit; a plane's 64-bit base is taken once per channel.  Two
// layouts, each the fastest measured on an H100 for its launches:
// - RUN, for the C = 3 frame pairs: a grid of (row tile, row block, image)
//   blocks of (tx, ty) threads, no division; a thread takes PPT = 2
//   consecutive pixels of a row, reads their flow, computes their
//   coordinates, tap offsets and weights once, then for each channel (the
//   loop unrolled) gathers 8 taps and writes 2 outputs.  The dx and dy
//   runs and the outputs go as 4-byte accesses where the row's width and
//   the addresses allow (RUN_VEC); else value by value.  One pixel a
//   thread, or 4 or 8, was slower.
// - FLAT, for feature maps: a grid of (pixel blocks, channel groups of 16,
//   images); a block takes the plane's next MAX_THREADS pixels, a thread
//   one pixel, whose row it finds with one 32-bit division for all its
//   channels.  Row tiles with
//   the channel groups folded into grid.z beside the images (no division)
//   ran 4-9% slower at the context levels, and the same flat layout inside
//   the RUN kernel's template 5-20% slower than this short kernel: on the
//   card, the grid's shape and the compiled loop, not the arithmetic, set
//   the difference.

#include "warp_taps.cuh"

namespace {

constexpr int PPT = 2;  // pixels a thread of RUN and RUN_VEC; the wrapper's K1_PPT

constexpr int MAX_THREADS = 256;
// RUN: a thread's PPT consecutive pixels of a row tile, read and written
// value by value; RUN_VEC: the same with the dx/dy runs and the outputs as
// vector accesses.
constexpr int RUN = 0, RUN_VEC = 1, FLAT = 2;

// The frame pairs' layout: block (tile, row block, image) of (tx, ty)
// threads; CT = C, or 0 to read C at run time.
template <typename T, typename F, int CT, int MODE>
__global__ void __launch_bounds__(MAX_THREADS)
warp_planes_kernel(const T* __restrict__ img, const F* __restrict__ flow,
                   T* __restrict__ out, int C, int H, int W) {
  const int xb = (blockIdx.x * blockDim.x + threadIdx.x) * PPT;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (xb >= W || y >= H) return;
  const int n = blockIdx.z;
  const int64_t hw = (int64_t)H * W;
  const int row = y * W;

  const F* fl = flow + 2 * n * hw + row;
  float dx[PPT], dy[PPT];
  if (MODE == RUN_VEC) {
    load_run<PPT>(fl + xb, dx);
    load_run<PPT>(fl + hw + xb, dy);
  } else {
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      // A pixel past the row's end repeats the row's last and stores nothing.
      const int x = min(xb + j, W - 1);
      dx[j] = load_f(fl + x);
      dy[j] = load_f(fl + hw + x);
    }
  }
  int a00[PPT], a01[PPT], a10[PPT], a11[PPT];
  float fx[PPT], fy[PPT], gx[PPT], gy[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const Coords k = coords_at(min(xb + j, W - 1), y, dx[j], dy[j], H, W);
    const int r0 = k.y0 * W, r1 = k.y1 * W;
    a00[j] = r0 + k.x0;
    a01[j] = r0 + k.x1;
    a10[j] = r1 + k.x0;
    a11[j] = r1 + k.x1;
    fx[j] = k.fx;
    fy[j] = k.fy;
    gx[j] = k.gx;
    gy[j] = k.gy;
  }
  const int64_t plane = (int64_t)n * C * hw;
  const T* src = img + plane;
  T* dst = out + plane + row + xb;
  auto one_channel = [&]() {
    float v[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      v[j] = blend4(load_f(src + a00[j]), load_f(src + a01[j]), load_f(src + a10[j]),
                    load_f(src + a11[j]), fx[j], fy[j], gx[j], gy[j]);
    }
    if (MODE == RUN_VEC) {
      store_run<PPT>(dst, v);
    } else {
#pragma unroll
      for (int j = 0; j < PPT; ++j)
        if (xb + j < W) store_f(dst + j, v[j]);
    }
    src += hw;
    dst += hw;
  };
  if (CT > 0) {
#pragma unroll
    for (int c = 0; c < CT; ++c) one_channel();
  } else {
    for (int c = 0; c < C; ++c) one_channel();
  }
}

// The feature maps' layout: block (pixel block, channel group, image) of
// MAX_THREADS threads, a pixel a thread, `cg` channels a block.
template <typename T, typename F>
__global__ void __launch_bounds__(MAX_THREADS)
warp_planes_flat_kernel(const T* __restrict__ img, const F* __restrict__ flow,
                        T* __restrict__ out, int C, int H, int W, int cg) {
  const int p = blockIdx.x * MAX_THREADS + threadIdx.x;
  if (p >= H * W) return;
  const int n = blockIdx.z;
  const int c_begin = blockIdx.y * cg;
  const int c_end = min(c_begin + cg, C);
  const int y = p / W;  // once a thread, for all its channels
  const int x = p - y * W;
  const int64_t hw = (int64_t)H * W;
  const F* fl = flow + 2 * n * hw;
  const Coords k = coords_at(x, y, load_f(fl + p), load_f(fl + hw + p), H, W);
  const int i00 = k.y0 * W + k.x0, i01 = k.y0 * W + k.x1;
  const int i10 = k.y1 * W + k.x0, i11 = k.y1 * W + k.x1;
  for (int c = c_begin; c < c_end; ++c) {
    const int64_t base = ((int64_t)n * C + c) * hw;
    const T* s = img + base;
    store_f(out + base + p, blend4(load_f(s + i00), load_f(s + i01), load_f(s + i10),
                                   load_f(s + i11), k.fx, k.fy, k.gx, k.gy));
  }
}

template <typename T, typename F, int MODE>
void launch_run(const void* img, const void* flow, void* out, int C, int H, int W,
                dim3 grid, dim3 block, cudaStream_t s) {
  const T* im = static_cast<const T*>(img);
  const F* fl = static_cast<const F*>(flow);
  T* o = static_cast<T*>(out);
  if (C == 3) {
    warp_planes_kernel<T, F, 3, MODE><<<grid, block, 0, s>>>(im, fl, o, C, H, W);
  } else {
    warp_planes_kernel<T, F, 0, MODE><<<grid, block, 0, s>>>(im, fl, o, C, H, W);
  }
}

template <typename T, typename F>
int launch_typed(const void* img, const void* flow, void* out, int N, int C, int H,
                 int W, int gx, int gy, int tx, int ty, int ppt, int cg, int mode,
                 cudaStream_t s) {
  if (tx < 1 || ty < 1 || tx * ty > MAX_THREADS || gy < 1 || gy > 65535 || N > 65535 ||
      mode < RUN || mode > FLAT || ppt != (mode == FLAT ? 1 : PPT) ||
      (mode == FLAT && (tx != MAX_THREADS || ty != 1 || cg < 1)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(gx, gy, N), block(tx, ty);
  if (mode == FLAT) {
    warp_planes_flat_kernel<T, F><<<grid, block, 0, s>>>(
        static_cast<const T*>(img), static_cast<const F*>(flow), static_cast<T*>(out), C,
        H, W, cg);
  } else if (mode == RUN) {
    launch_run<T, F, RUN>(img, flow, out, C, H, W, grid, block, s);
  } else {
    launch_run<T, F, RUN_VEC>(img, flow, out, C, H, W, grid, block, s);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* img, const void* flow, void* out, int N, int C, int H, int W,
           int flow_is_bf16, int gx, int gy, int tx, int ty, int ppt, int cg, int mode,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return flow_is_bf16
             ? launch_typed<T, __nv_bfloat16>(img, flow, out, N, C, H, W, gx, gy, tx, ty,
                                              ppt, cg, mode, s)
             : launch_typed<T, float>(img, flow, out, N, C, H, W, gx, gy, tx, ty, ppt, cg,
                                      mode, s);
}

}  // namespace

// img, out: (N, C, H, W) in the named type; flow: (N, 2, H, W) f32 or bf16
// (flow_is_bf16).  The launch from the wrapper (ops/cuda/warp.py k1_plan):
// a grid of (gx, gy, N) blocks of (tx, ty) threads, `ppt` pixels a thread;
// `mode`: 0 (RUN), row tiles x row blocks, ppt = 2 consecutive pixels a
// thread, every channel; 1 (RUN_VEC), the same with the dx/dy runs and
// the output runs as vector accesses (W even, the flow's and the output's
// addresses multiples of the run's bytes); 2 (FLAT), blocks of 256 pixels
// x channel groups of `cg`, a pixel a thread (ppt = 1).  Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a launch it does not
// take).
extern "C" int warp_planes_bf16(const void* img, const void* flow, void* out, int N,
                                int C, int H, int W, int flow_is_bf16, int gx, int gy,
                                int tx, int ty, int ppt, int cg, int mode, void* stream) {
  return launch<__nv_bfloat16>(img, flow, out, N, C, H, W, flow_is_bf16, gx, gy, tx, ty,
                               ppt, cg, mode, stream);
}

extern "C" int warp_planes_f32(const void* img, const void* flow, void* out, int N,
                               int C, int H, int W, int flow_is_bf16, int gx, int gy, int tx,
                               int ty, int ppt, int cg, int mode, void* stream) {
  return launch<float>(img, flow, out, N, C, H, W, flow_is_bf16, gx, gy, tx, ty, ppt, cg,
                       mode, stream);
}
