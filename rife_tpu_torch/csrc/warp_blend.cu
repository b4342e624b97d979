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
// bf16).  emit_pair also writes w0 and w1 (the paper model's U-Net reads
// them); otherwise only the blend is written (v4.25).
//
// Bound: bytes.  A launch must read both images, the flow and the mask
// once and write the blend (and w0, w1) once; it does about 25 flops per
// output element, far below the card's ratio of operations to bytes.
// Layout as K1: one thread per output pixel and run of CH_PER_THREAD
// channels (grid.y), batch on grid.z.  The thread reads the four flow
// values and the mask once, computes both images' coordinates, indices,
// weights and the sigmoid once, and for each channel gathers four taps of
// each image straight from device memory, which L1 and L2 serve as in K1.
// The TPU kernel's windows, scalar prefetch and packed taps are not carried
// over, so the warp is exact for every flow.

#include "warp_taps.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CH_PER_THREAD = 16;

// PAIR (emit_pair) is a template parameter, not a null test in the loop:
// with a runtime test the blend-only form ran ~6% slower than the form
// that writes three outputs (H100, chip_smoke.py).
template <typename T, typename F, typename M, bool PAIR>
__global__ void __launch_bounds__(THREADS)
warp_blend_kernel(const T* __restrict__ img0, const T* __restrict__ img1,
                  const F* __restrict__ flow, const M* __restrict__ mask,
                  T* __restrict__ blend, T* __restrict__ w0,
                  T* __restrict__ w1, int C, int H, int W) {
  const int64_t hw = (int64_t)H * W;
  const int64_t p = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (p >= hw) return;
  const int n = blockIdx.z;
  const int c_begin = blockIdx.y * CH_PER_THREAD;
  const int c_end = min(c_begin + CH_PER_THREAD, C);
  const int y = (int)(p / W);
  const int x = (int)(p - (int64_t)y * W);

  const F* fl = flow + (int64_t)n * 4 * hw;
  const Taps t0 = taps_at(x, y, load_f(fl + p), load_f(fl + hw + p), H, W);
  const Taps t1 =
      taps_at(x, y, load_f(fl + 2 * hw + p), load_f(fl + 3 * hw + p), H, W);
  const float m = load_f(mask + (int64_t)n * hw + p);
  const float s = round_as(1.0f / (1.0f + expf(-m)), blend);
  const float s1 = __fsub_rn(1.0f, s);
  for (int c = c_begin; c < c_end; ++c) {
    const int64_t base = ((int64_t)n * C + c) * hw;
    const float v0 = round_as(bilerp(img0 + base, t0), blend);
    const float v1 = round_as(bilerp(img1 + base, t1), blend);
    store_f(blend + base + p, __fadd_rn(__fmul_rn(v0, s), __fmul_rn(v1, s1)));
    if (PAIR) {
      store_f(w0 + base + p, v0);
      store_f(w1 + base + p, v1);
    }
  }
}

template <typename T, typename F, typename M>
int launch_typed(const void* img0, const void* img1, const void* flow,
                 const void* mask, void* blend, void* w0, void* w1, int N,
                 int C, int H, int W, cudaStream_t s) {
  const int64_t hw = (int64_t)H * W;
  const dim3 grid((unsigned)((hw + THREADS - 1) / THREADS),
                  (unsigned)((C + CH_PER_THREAD - 1) / CH_PER_THREAD),
                  (unsigned)N);
  const auto* a = static_cast<const T*>(img0);
  const auto* b = static_cast<const T*>(img1);
  const auto* f = static_cast<const F*>(flow);
  const auto* m = static_cast<const M*>(mask);
  if (w0 != nullptr) {
    warp_blend_kernel<T, F, M, true><<<grid, THREADS, 0, s>>>(
        a, b, f, m, static_cast<T*>(blend), static_cast<T*>(w0),
        static_cast<T*>(w1), C, H, W);
  } else {
    warp_blend_kernel<T, F, M, false><<<grid, THREADS, 0, s>>>(
        a, b, f, m, static_cast<T*>(blend), nullptr, nullptr, C, H, W);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename F>
int launch_mask(const void* img0, const void* img1, const void* flow,
                const void* mask, void* blend, void* w0, void* w1, int N,
                int C, int H, int W, int mask_is_bf16, cudaStream_t s) {
  if (mask_is_bf16) {
    return launch_typed<T, F, __nv_bfloat16>(img0, img1, flow, mask, blend, w0,
                                             w1, N, C, H, W, s);
  }
  return launch_typed<T, F, float>(img0, img1, flow, mask, blend, w0, w1, N,
                                   C, H, W, s);
}

template <typename T>
int launch(const void* img0, const void* img1, const void* flow,
           const void* mask, void* blend, void* w0, void* w1, int N, int C,
           int H, int W, int flow_is_bf16, int mask_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (flow_is_bf16) {
    return launch_mask<T, __nv_bfloat16>(img0, img1, flow, mask, blend, w0, w1,
                                         N, C, H, W, mask_is_bf16, s);
  }
  return launch_mask<T, float>(img0, img1, flow, mask, blend, w0, w1, N, C, H,
                               W, mask_is_bf16, s);
}

}  // namespace

// img0, img1, blend, w0, w1: (N, C, H, W) in the named type; flow
// (N, 4, H, W) and mask (N, 1, H, W) each f32 or bf16 (flow_is_bf16,
// mask_is_bf16); w0 and w1 both null for the blend-only form.  Returns the
// CUDA error of the launch (0 when launched).
extern "C" int warp_blend_bf16(const void* img0, const void* img1,
                               const void* flow, const void* mask, void* blend,
                               void* w0, void* w1, int N, int C, int H, int W,
                               int flow_is_bf16, int mask_is_bf16,
                               void* stream) {
  return launch<__nv_bfloat16>(img0, img1, flow, mask, blend, w0, w1, N, C, H,
                               W, flow_is_bf16, mask_is_bf16, stream);
}

extern "C" int warp_blend_f32(const void* img0, const void* img1,
                              const void* flow, const void* mask, void* blend,
                              void* w0, void* w1, int N, int C, int H, int W,
                              int flow_is_bf16, int mask_is_bf16,
                              void* stream) {
  return launch<float>(img0, img1, flow, mask, blend, w0, w1, N, C, H, W,
                       flow_is_bf16, mask_is_bf16, stream);
}
