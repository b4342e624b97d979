// Backward bilinear warp of (N, C, H, W) planes by (N, 2, H, W) pixel flow.
//
// Replaces the TPU kernel rife_tpu/ops/pallas/warp_v5.py:warp_pallas_v5_pl
// (kernel _warp_kernel_v5), forward only.  Semantics (rife_tpu/ops/warp.py
// warp_xla_planes): out[n, c, y, x] samples plane c at
// (clamp(x + dx, 0, W-1), clamp(y + dy, 0, H-1)) with x1 = min(x0+1, W-1),
// y1 = min(y0+1, H-1); coordinates are f32 even for a bf16 flow.  The blend
// is accumulated in f32 and stored in the image's type: a bf16 image gives
// bf16 taps with f32 math (as the TPU kernel does), an f32 image stays f32
// throughout (the TPU kernel would have rounded its taps to bf16).
//
// Bound: bytes.  Each launch must read the image and the flow once and write
// the output once (2 B an element in bf16); it does 9 flops per output
// element, far below the card's ratio of operations to bytes.  The design
// keeps the traffic near that minimum: the TPU kernel's 96-row windows,
// scalar prefetch, packed bf16 x-tap pairs and (8,128) tiles are not carried
// over.  Each thread owns one output pixel and a run of CH_PER_THREAD
// channels: it reads the flow once, computes the coordinate, the four
// indices and the four weights once, and gathers its taps straight from
// device memory.  Neighbouring threads read neighbouring taps, so L1 and L2
// (50 MB, which holds a 720p bf16 plane) absorb the four-fold tap re-reads.
// Splitting the channels over grid.y keeps the grid large at the coarse,
// many-channel context levels.  No window, so the warp is exact for every
// flow, and any H and W.

#include "warp_taps.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CH_PER_THREAD = 16;

template <typename T, typename F>
__global__ void __launch_bounds__(THREADS)
warp_planes_kernel(const T* __restrict__ img, const F* __restrict__ flow,
                   T* __restrict__ out, int C, int H, int W) {
  const int64_t hw = (int64_t)H * W;
  const int64_t p = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (p >= hw) return;
  const int n = blockIdx.z;
  const int c_begin = blockIdx.y * CH_PER_THREAD;
  const int c_end = min(c_begin + CH_PER_THREAD, C);
  const int y = (int)(p / W);
  const int x = (int)(p - (int64_t)y * W);

  const F* fl = flow + (int64_t)n * 2 * hw;
  const Taps t = taps_at(x, y, load_f(fl + p), load_f(fl + hw + p), H, W);
  for (int c = c_begin; c < c_end; ++c) {
    const int64_t base = ((int64_t)n * C + c) * hw;
    store_f(out + base + p, bilerp(img + base, t));
  }
}

template <typename T>
int launch(const void* img, const void* flow, void* out, int N, int C, int H,
           int W, int flow_is_bf16, void* stream) {
  const int64_t hw = (int64_t)H * W;
  const dim3 grid((unsigned)((hw + THREADS - 1) / THREADS),
                  (unsigned)((C + CH_PER_THREAD - 1) / CH_PER_THREAD),
                  (unsigned)N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (flow_is_bf16) {
    warp_planes_kernel<T, __nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(img), static_cast<const __nv_bfloat16*>(flow),
        static_cast<T*>(out), C, H, W);
  } else {
    warp_planes_kernel<T, float><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(img), static_cast<const float*>(flow),
        static_cast<T*>(out), C, H, W);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int warp_planes_bf16(const void* img, const void* flow, void* out,
                                int N, int C, int H, int W, int flow_is_bf16,
                                void* stream) {
  return launch<__nv_bfloat16>(img, flow, out, N, C, H, W, flow_is_bf16, stream);
}

extern "C" int warp_planes_f32(const void* img, const void* flow, void* out,
                               int N, int C, int H, int W, int flow_is_bf16,
                               void* stream) {
  return launch<float>(img, flow, out, N, C, H, W, flow_is_bf16, stream);
}
