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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CH_PER_THREAD = 16;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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
  const float ix = fminf(fmaxf((float)x + load_f(fl + p), 0.0f), (float)(W - 1));
  const float iy = fminf(fmaxf((float)y + load_f(fl + hw + p), 0.0f), (float)(H - 1));
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
  for (int c = c_begin; c < c_end; ++c) {
    const int64_t base = ((int64_t)n * C + c) * hw;
    const T* src = img + base;
    // The plain version's operations in its order, each rounded on its own
    // (the _rn intrinsics are never contracted into an FMA): the kernel
    // then gives the plain version's f32 result bit for bit.  A contracted
    // FMA would differ by an f32 rounding, which where the taps cancel is
    // more than one bf16 ulp of the small result.
    const float top = __fadd_rn(__fmul_rn(load_f(src + i00), gx),
                                __fmul_rn(load_f(src + i01), fx));
    const float bot = __fadd_rn(__fmul_rn(load_f(src + i10), gx),
                                __fmul_rn(load_f(src + i11), fx));
    store_f(out + base + p, __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy)));
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
