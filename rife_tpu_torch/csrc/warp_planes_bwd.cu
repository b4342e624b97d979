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
// a bf16 flow (warp_taps.cuh's coords_at, the forward's); all sums are f32.
//
// Bound: bytes.  The function must read g, the image and the flow once and
// write d_flow (and d_img, where it is asked for) once; it does about 20
// flops per element of g, far below the card's ratio of operations to bytes.
// The TPU kernel stored dI/dx and dI/dy (two more N*C*H*W tensors) in the
// forward so that XLA never re-gathered; on Hopper recomputing is cheaper
// than storing, so the forward is unchanged and this kernel recomputes the
// coordinate and weights once per pixel from the flow and re-reads the four
// taps, which L1 and L2 serve as in the forward.
//
// The design (the wrapper's bwd_plan in ops/cuda/warp.py computes the
// launch, so the CPU tests hold its arithmetic):
// - A block of 256 threads takes a 2-D tile of TX x TY output pixels of one
//   image (powers of two) and all C channels of them: thread t is pixel
//   t mod P (P = TX x TY >= 32, so a warp holds one channel group's pixels)
//   of channel group t / P, by masks and shifts, so no thread divides to
//   find its pixel.  At most 8 groups: with more, a warp's reductions would
//   spread over several planes.  Offsets within a plane are 32-bit; a plane's 64-bit
//   base is taken once per channel.
// - d_flow in one pass: group gi sums channels gi, gi + G, gi + 2G, ... in
//   that order in registers; the groups' sums meet in shared memory and
//   are added in group order, and d_flow is written once, in the flow's
//   type.  The order is fixed by the plan, so d_flow is the same bit for
//   bit from run to run.
// - d_img is added tap by tap into an f32 scratch (the wrapper zeroes it
//   before and casts it to the image's type after) with global reductions
//   (red.global.add.f32), which set the pace at the context levels.  A
//   warp of a 32-wide tile is 32 pixels of one row; a lane's right taps go
//   to its right neighbour (a warp shuffle) wherever they are that
//   neighbour's left taps, which takes a smooth flow's reductions from 4
//   an element of g towards 2.  The sum is exact either way; its order is
//   the atomics', so d_img may differ in its last bits from run to run.
// - Measured on an H100 and dropped: a shared-memory box of the tile's
//   taps flushed once per cell (Hopper has no shared-memory f32 atomic add;
//   nvcc's compare-and-swap loop cost more than the global reductions it
//   saved at every training shape), and 16-byte vector reductions of
//   regular 33-cell runs gathered by shuffles (too few warps of a real
//   flow form such runs to show).

#include "warp_taps.cuh"

namespace {

constexpr int THREADS = 256;

// merges: null, or two counters: pixels that handed their right taps to
// their right neighbour and pixels that added them themselves (summed over
// the channel groups; two atomics a warp; a diagnostic the wrapper asks for).
template <typename T, typename F, bool NEED_IMG, bool NEED_FLOW>
__global__ void __launch_bounds__(THREADS)
warp_planes_bwd_kernel(const T* __restrict__ img, const F* __restrict__ flow,
                       const T* __restrict__ g, float* __restrict__ d_img,
                       F* __restrict__ d_flow, int C, int H, int W, int tx_shift,
                       int p_shift, int* __restrict__ merges) {
  __shared__ float part[2][THREADS];  // the channel groups' d_flow sums
  const int t = threadIdx.x, lane = t & 31;
  const int p = t & ((1 << p_shift) - 1);
  const int gi = t >> p_shift;
  const int groups = THREADS >> p_shift;
  const int px = p & ((1 << tx_shift) - 1);
  const int x = (blockIdx.x << tx_shift) + px;
  const int y = (blockIdx.y << (p_shift - tx_shift)) + (p >> tx_shift);
  const int n = blockIdx.z;
  const bool live = x < W && y < H;
  const int xc = min(x, W - 1), yc = min(y, H - 1);
  const int64_t hw = (int64_t)H * W;
  const int pix = yc * W + xc;

  const F* fl = flow + 2 * n * hw + pix;
  const float dx = load_f(fl), dy = load_f(fl + hw);
  const Coords k = coords_at(xc, yc, dx, dy, H, W);
  const int r0 = k.y0 * W, r1 = k.y1 * W;
  const int ab[4] = {r0 + k.x0, r0 + k.x1, r1 + k.x0, r1 + k.x1};
  const int64_t plane0 = (int64_t)n * C * hw;
  const int per_thread = (C + groups - 1) >> (8 - p_shift);

  float sx = 0.0f, sy = 0.0f;
  // Channel c's cotangent at this pixel; adds its d_flow terms to sx, sy.
  auto terms = [&](int c) {
    const int64_t base = plane0 + c * hw;
    const float gv = load_f(g + base + pix);
    if (NEED_FLOW) {
      const T* src = img + base;
      const float v00 = load_f(src + ab[0]), v01 = load_f(src + ab[1]);
      const float v10 = load_f(src + ab[2]), v11 = load_f(src + ab[3]);
      sx += gv * ((v01 - v00) * k.gy + (v11 - v10) * k.fy);
      sy += gv * ((v10 - v00) * k.gx + (v11 - v01) * k.fx);
    }
    return gv;
  };

  if (NEED_IMG) {
    // Along a row of the tile, a lane's right taps are its right neighbour's
    // left taps wherever the two pixels' tap columns meet on the same tap
    // rows: the neighbour takes them over (a shuffle a channel) and adds
    // them into its own, so that such a pair of cells takes one reduction,
    // not two.  Both lanes test the same condition.
    const int lx1 = __shfl_up_sync(~0u, k.x1, 1), ly0 = __shfl_up_sync(~0u, k.y0, 1);
    const int ly1 = __shfl_up_sync(~0u, k.y1, 1), rx0 = __shfl_down_sync(~0u, k.x0, 1);
    const int ry0 = __shfl_down_sync(~0u, k.y0, 1), ry1 = __shfl_down_sync(~0u, k.y1, 1);
    const bool llive = __shfl_up_sync(~0u, live, 1), rlive = __shfl_down_sync(~0u, live, 1);
    const bool take = px > 0 && live && llive && lx1 == k.x0 && ly0 == k.y0 && ly1 == k.y1;
    const bool give = px < (1 << tx_shift) - 1 && live && rlive && k.x1 == rx0 &&
                      k.y0 == ry0 && k.y1 == ry1;
    if (merges != nullptr) {  // pixels that handed over their right taps, and the rest
      const unsigned gave = __ballot_sync(~0u, give), kept = __ballot_sync(~0u, live && !give);
      if (lane == 0) {
        atomicAdd(merges, __popc(gave));
        atomicAdd(merges + 1, __popc(kept));
      }
    }
#pragma unroll 4
    for (int j = 0; j < per_thread; ++j) {
      const int c = gi + j * groups;
      const bool ok = live && c < C;
      const float gv = ok ? terms(c) : 0.0f;
      const float gyv = gv * k.gy, fyv = gv * k.fy;
      float w00 = gyv * k.gx, w10 = fyv * k.gx;
      const float w01 = gyv * k.fx, w11 = fyv * k.fx;
      const float l01 = __shfl_up_sync(~0u, w01, 1), l11 = __shfl_up_sync(~0u, w11, 1);
      if (!ok) continue;
      if (take) {
        w00 += l01;
        w10 += l11;
      }
      float* dst = d_img + plane0 + c * hw;
      atomicAdd(dst + ab[0], w00);
      atomicAdd(dst + ab[2], w10);
      if (!give) {
        atomicAdd(dst + ab[1], w01);
        atomicAdd(dst + ab[3], w11);
      }
    }
  } else if (live) {
#pragma unroll 4
    for (int c = gi; c < C; c += groups) terms(c);
  }

  if (NEED_FLOW) {
    if (groups > 1) {
      part[0][t] = sx;
      part[1][t] = sy;
      __syncthreads();
      if (gi != 0) return;
      for (int j = 1; j < groups; ++j) {
        sx += part[0][(j << p_shift) + p];
        sy += part[1][(j << p_shift) + p];
      }
    }
    if (!live) return;
    const float rawx = (float)xc + dx;
    const float rawy = (float)yc + dy;
    const bool inx = rawx > 0.0f && rawx < (float)(W - 1);
    const bool iny = rawy > 0.0f && rawy < (float)(H - 1);
    F* out = d_flow + 2 * n * hw + pix;
    store_f(out, inx ? sx : 0.0f);
    store_f(out + hw, iny ? sy : 0.0f);
  }
}

template <typename T, typename F, bool NI, bool NF>
int launch_flags(const void* img, const void* flow, const void* g, void* d_img,
                 void* d_flow, int C, int H, int W, dim3 grid, int tx_shift, int p_shift,
                 int* merges, cudaStream_t s) {
  warp_planes_bwd_kernel<T, F, NI, NF><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(img), static_cast<const F*>(flow), static_cast<const T*>(g),
      static_cast<float*>(d_img), static_cast<F*>(d_flow), C, H, W, tx_shift, p_shift,
      merges);
  return (int)cudaGetLastError();
}

template <typename T, typename F>
int launch_typed(const void* img, const void* flow, const void* g, void* d_img,
                 void* d_flow, int N, int C, int H, int W, int tx_shift, int p_shift,
                 int* merges, cudaStream_t s) {
  // tx_shift <= 5: a tile's row lies within one warp, lane 0 at its first
  // column, which the shuffle merge of d_img's taps relies on.
  if (p_shift < 5 || p_shift > 8 || tx_shift < 0 || tx_shift > 5 || N > 65535 ||
      (d_img == nullptr && d_flow == nullptr))
    return (int)cudaErrorInvalidValue;
  const int ty = 1 << (p_shift - tx_shift);
  const dim3 grid((W + (1 << tx_shift) - 1) >> tx_shift, (H + ty - 1) / ty, N);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (d_img != nullptr && d_flow != nullptr)
    return launch_flags<T, F, true, true>(img, flow, g, d_img, d_flow, C, H, W, grid,
                                          tx_shift, p_shift, merges, s);
  if (d_img != nullptr)
    return launch_flags<T, F, true, false>(img, flow, g, d_img, d_flow, C, H, W, grid,
                                           tx_shift, p_shift, merges, s);
  return launch_flags<T, F, false, true>(img, flow, g, d_img, d_flow, C, H, W, grid,
                                         tx_shift, p_shift, merges, s);
}

template <typename T>
int launch(const void* img, const void* flow, const void* g, void* d_img, void* d_flow,
           int N, int C, int H, int W, int flow_is_bf16, int tx_shift, int p_shift,
           void* merges, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* m = static_cast<int*>(merges);
  return flow_is_bf16
             ? launch_typed<T, __nv_bfloat16>(img, flow, g, d_img, d_flow, N, C, H, W,
                                              tx_shift, p_shift, m, s)
             : launch_typed<T, float>(img, flow, g, d_img, d_flow, N, C, H, W, tx_shift,
                                      p_shift, m, s);
}

}  // namespace

// img, g: (N, C, H, W) in the named type; flow, d_flow: (N, 2, H, W) f32 or
// bf16 (flow_is_bf16); d_img: a zeroed f32 (N, C, H, W) scratch, or null
// when d_img is not needed; d_flow null when it is not needed (not both).
// The launch from the wrapper (ops/cuda/warp.py bwd_plan): 256 threads a
// block, tiles of 2^tx_shift x 2^(p_shift - tx_shift) pixels (TX = 2^tx_shift
// <= 32, P = 2^p_shift >= 32 pixels, 256 / P channel groups), a grid of (ceil(W /
// TX), ceil(H / TY), N); `merges`: null, or two int counters (pixels by
// whether their right taps went to their neighbour).  Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a launch it does not take).
extern "C" int warp_planes_bwd_bf16(const void* img, const void* flow, const void* g,
                                    void* d_img, void* d_flow, int N, int C, int H,
                                    int W, int flow_is_bf16, int tx_shift, int p_shift,
                                    void* merges, void* stream) {
  return launch<__nv_bfloat16>(img, flow, g, d_img, d_flow, N, C, H, W, flow_is_bf16,
                               tx_shift, p_shift, merges, stream);
}

extern "C" int warp_planes_bwd_f32(const void* img, const void* flow, const void* g,
                                   void* d_img, void* d_flow, int N, int C, int H, int W,
                                   int flow_is_bf16, int tx_shift, int p_shift,
                                   void* merges, void* stream) {
  return launch<float>(img, flow, g, d_img, d_flow, N, C, H, W, flow_is_bf16, tx_shift,
                       p_shift, merges, stream);
}
