// Gradient of the backward bilinear warp of (N, C, H, W) planes by
// (N, 2, H, W) pixel flow (the forward is csrc/warp_planes.cu).
//
// Replaces the gradient half of the TPU kernel
// rife_tpu/ops/pallas/warp_v5.py:warp_pallas_v5_pl(..., emit_grads=True)
// (the coordinate derivatives of _warp_kernel_v5) together with its VJP
// rife_tpu/ops/warp.py:_planes_diff_bwd.  With ix = clamp(x + dx, 0, W-1),
// iy = clamp(y + dy, 0, H-1), fx = ix - floor(ix), fy = iy - floor(iy) and
// the four taps v00 v01 v10 v11 of the forward, for a cotangent g:
//
//   d_flow[n, 0] = sum_c g * ((v01 - v00) * (1 - fy) + (v11 - v10) * fy)
//   d_flow[n, 1] = sum_c g * ((v10 - v00) * (1 - fx) + (v11 - v01) * fx)
//
// each zeroed where the raw coordinate was clamped, with the strict test
// 0 < x + dx < W - 1 (resp. y) of the TPU VJP; at fy == 0 the y derivative
// is v[y0 + 1] - v[y0], the convention of warp_v5.py's _dw.  d_img is the
// exact adjoint of the 4-tap gather with the flow held constant: each output
// pixel adds g * w into the four taps it read.  Coordinates are f32 even for
// a bf16 flow; all sums are f32.
//
// Bound: bytes.  The function must read g, the image and the flow once and
// write d_flow (and d_img, where it is asked for) once; it does about 20
// flops per element of g, far below the card's ratio of operations to bytes.
// The TPU kernel stored dI/dx and dI/dy (two more N*C*H*W tensors) in the
// forward so that XLA never re-gathered; on Hopper recomputing is cheaper
// than storing, so the forward is unchanged and this kernel recomputes the
// coordinate, indices and weights once per pixel from the flow and re-reads
// the four taps, which L1 and L2 serve as in the forward.  Each thread owns
// one pixel and a run of CH_PER_THREAD channels (grid.y splits the channels,
// which keeps the grid large at the coarse many-channel context levels): it
// sums its channels' d_flow terms in registers in channel order, and a
// second pass adds the runs in run order, so d_flow is deterministic.  d_img
// is a scatter: atomicAdd of g * w into an f32 scratch the wrapper zeroes
// and casts to the image's type afterwards; that scratch traffic (zero,
// read-modify-write, cast) is what this design moves beyond the bound, and
// only where d_img is needed (the context warps; the image warps of the
// flow levels and the teacher warp raw input frames).

#include "warp_taps.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CH_PER_THREAD = 16;

// part: (N, G, 2, H, W) f32 partial d_flow, one slab per channel run, or
// nullptr when d_flow is not needed.  d_img: (N, C, H, W) f32 scratch, or
// nullptr when d_img is not needed.
template <typename T, typename F>
__global__ void __launch_bounds__(THREADS)
warp_planes_bwd_kernel(const T* __restrict__ img, const F* __restrict__ flow,
                       const T* __restrict__ g, float* __restrict__ d_img,
                       float* __restrict__ part, int C, int H, int W) {
  const int64_t hw = (int64_t)H * W;
  const int64_t p = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (p >= hw) return;
  const int n = blockIdx.z;
  const int run = blockIdx.y;
  const int c_begin = run * CH_PER_THREAD;
  const int c_end = min(c_begin + CH_PER_THREAD, C);
  const int y = (int)(p / W);
  const int x = (int)(p - (int64_t)y * W);

  const F* fl = flow + (int64_t)n * 2 * hw;
  const float rawx = (float)x + load_f(fl + p);
  const float rawy = (float)y + load_f(fl + hw + p);
  const float ix = fminf(fmaxf(rawx, 0.0f), (float)(W - 1));
  const float iy = fminf(fmaxf(rawy, 0.0f), (float)(H - 1));
  const float x0f = floorf(ix);
  const float y0f = floorf(iy);
  const float fx = ix - x0f;
  const float fy = iy - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  const int64_t i00 = (int64_t)y0 * W + x0;
  const int64_t i01 = (int64_t)y0 * W + x1;
  const int64_t i10 = (int64_t)y1 * W + x0;
  const int64_t i11 = (int64_t)y1 * W + x1;
  const float gx = 1.0f - fx;
  const float gy = 1.0f - fy;

  float sx = 0.0f, sy = 0.0f;
  for (int c = c_begin; c < c_end; ++c) {
    const int64_t base = ((int64_t)n * C + c) * hw;
    const float gv = load_f(g + base + p);
    if (part != nullptr) {
      const T* src = img + base;
      const float v00 = load_f(src + i00), v01 = load_f(src + i01);
      const float v10 = load_f(src + i10), v11 = load_f(src + i11);
      sx += gv * ((v01 - v00) * gy + (v11 - v10) * fy);
      sy += gv * ((v10 - v00) * gx + (v11 - v01) * fx);
    }
    if (d_img != nullptr) {
      float* dst = d_img + base;
      const float gyv = gv * gy, fyv = gv * fy;
      atomicAdd(dst + i00, gyv * gx);
      atomicAdd(dst + i01, gyv * fx);
      atomicAdd(dst + i10, fyv * gx);
      atomicAdd(dst + i11, fyv * fx);
    }
  }
  if (part != nullptr) {
    const bool inx = rawx > 0.0f && rawx < (float)(W - 1);
    const bool iny = rawy > 0.0f && rawy < (float)(H - 1);
    float* out = part + ((int64_t)n * gridDim.y + run) * 2 * hw;
    out[p] = inx ? sx : 0.0f;
    out[hw + p] = iny ? sy : 0.0f;
  }
}

// d_flow[n, k, p] = sum over runs r (in order) of part[n, r, k, p].
template <typename F>
__global__ void __launch_bounds__(THREADS)
sum_runs_kernel(const float* __restrict__ part, F* __restrict__ d_flow,
                int runs, int64_t hw2) {
  const int64_t q = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (q >= hw2) return;
  const int n = blockIdx.y;
  const float* src = part + (int64_t)n * runs * hw2 + q;
  float s = 0.0f;
  for (int r = 0; r < runs; ++r) s += src[(int64_t)r * hw2];
  store_f(d_flow + (int64_t)n * hw2 + q, s);
}

template <typename T, typename F>
int launch_typed(const void* img, const void* flow, const void* g, void* d_img,
                 void* part, void* d_flow, int N, int C, int H, int W,
                 cudaStream_t s) {
  const int64_t hw = (int64_t)H * W;
  const int runs = (C + CH_PER_THREAD - 1) / CH_PER_THREAD;
  const dim3 grid((unsigned)((hw + THREADS - 1) / THREADS), (unsigned)runs,
                  (unsigned)N);
  warp_planes_bwd_kernel<T, F><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(img), static_cast<const F*>(flow),
      static_cast<const T*>(g), static_cast<float*>(d_img),
      static_cast<float*>(part), C, H, W);
  int err = (int)cudaGetLastError();
  if (err != 0 || part == nullptr) return err;
  const dim3 grid2((unsigned)((2 * hw + THREADS - 1) / THREADS), (unsigned)N);
  sum_runs_kernel<F><<<grid2, THREADS, 0, s>>>(
      static_cast<const float*>(part), static_cast<F*>(d_flow), runs, 2 * hw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* img, const void* flow, const void* g, void* d_img,
           void* part, void* d_flow, int N, int C, int H, int W,
           int flow_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (flow_is_bf16) {
    return launch_typed<T, __nv_bfloat16>(img, flow, g, d_img, part, d_flow,
                                          N, C, H, W, s);
  }
  return launch_typed<T, float>(img, flow, g, d_img, part, d_flow, N, C, H, W,
                                s);
}

}  // namespace

// img, g: (N, C, H, W) in the named type; flow, d_flow: (N, 2, H, W) f32 or
// bf16 (flow_is_bf16); d_img: zeroed f32 (N, C, H, W) scratch or null; part:
// f32 (N, ceil(C / 16), 2, H, W) scratch, or null (with d_flow) when d_flow
// is not needed.  Returns the CUDA error of the launches (0 when launched).
extern "C" int warp_planes_bwd_bf16(const void* img, const void* flow,
                                    const void* g, void* d_img, void* part,
                                    void* d_flow, int N, int C, int H, int W,
                                    int flow_is_bf16, void* stream) {
  return launch<__nv_bfloat16>(img, flow, g, d_img, part, d_flow, N, C, H, W,
                               flow_is_bf16, stream);
}

extern "C" int warp_planes_bwd_f32(const void* img, const void* flow,
                                   const void* g, void* d_img, void* part,
                                   void* d_flow, int N, int C, int H, int W,
                                   int flow_is_bf16, void* stream) {
  return launch<float>(img, flow, g, d_img, part, d_flow, N, C, H, W,
                       flow_is_bf16, stream);
}

extern "C" int warp_planes_bwd_runs(int C) {
  return (C + CH_PER_THREAD - 1) / CH_PER_THREAD;
}
