// Backward bilinear warp of NHWC images (N, H, W, C) by NHWC pixel flow
// (N, H, W, 2): the warp of the legacy models (hd, hdv2), whose images and
// context features are channels-last.
//
// Replaces the TPU kernels rife_tpu/ops/pallas/warp.py:warp_pallas (K3,
// kernel _warp_kernel at :110, pallas_call at :288; warp_pallas_auto sends
// it f32 images with C < 8, warp_pallas_diff its gradient's forward) and
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
// thread gathers its taps straight from device memory through the
// read-only path, so the warp is exact for every flow, and L1 and L2
// absorb the four-fold tap re-reads.
//
// - K3 (meant for C < 8).  At C = 3 a pixel is 12 bytes of output in f32
//   and 6 in bf16: a thread per pixel that stores its channels one by one
//   issues C partial-sector stores per warp, and a flat pixel index costs
//   it two 64-bit divisions.  The design: a grid over (x tile, row,
//   image), so no thread divides; the image's, the row's and the tap
//   rows' 64-bit bases are taken once each, offsets within a row are
//   32-bit (the wrapper checks that they fit).  A block's tile is
//   K3_PPT x blockDim.x pixels of one row, a thread's K3_PPT pixels
//   blockDim.x apart, so each load instruction of a warp reads
//   neighbouring pixels and each thread has 4 x C x K3_PPT independent
//   tap loads in flight.  The flow pair is one 8- or 4-byte load where
//   the wrapper allows it.  The outputs are staged in shared memory and
//   leave as the row's contiguous span of tile x C elements, 16 bytes a
//   thread where the wrapper allows it (the span's start a multiple of 16
//   bytes), the ragged end element by element.  C = 3 is compiled with
//   its channel loop unrolled; any other C takes the same body with C
//   read at run time.
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

// K3's pixels per thread; ops/cuda/warp_nhwc.py K3_PPT says the same.
constexpr int K3_PPT = 2;
constexpr int K3_MAX_THREADS = 256;

// K3: block (tile, y, n) warps pixels x0 .. x0 + K3_PPT * blockDim.x - 1
// of row y of image n.  CT = C, or 0 to read C from C_rt; FVEC: one load
// per flow pair; vec_store: 16-byte stores of the staged span.  Dynamic
// shared memory: K3_PPT * blockDim.x * C elements of T.
template <typename T, typename F, int CT, bool FVEC>
__global__ void __launch_bounds__(K3_MAX_THREADS)
warp_nhwc_k3_kernel(const T* __restrict__ img, Strides is,
                    const F* __restrict__ flow, Strides fs,
                    T* __restrict__ out, int H, int W, int C_rt, int vec_store) {
  extern __shared__ __align__(16) unsigned char stage_bytes[];
  T* stage = reinterpret_cast<T*>(stage_bytes);
  const int C = CT > 0 ? CT : C_rt;
  const int nt = blockDim.x, t = threadIdx.x;
  const int x0 = blockIdx.x * nt * K3_PPT, y = blockIdx.y, n = blockIdx.z;
  const int npx = min(nt * K3_PPT, W - x0);
  const int isy = (int)is.y, isx = (int)is.x, fsx = (int)fs.x;
  const T* src = img + n * is.n;
  const F* frow = flow + n * fs.n + (int64_t)y * fs.y;
  Coords k[K3_PPT];
#pragma unroll
  for (int j = 0; j < K3_PPT; ++j) {
    // A thread past the row's end takes its last pixel and stores nothing.
    const int x = min(x0 + t + j * nt, W - 1);
    float dx, dy;
    load_pair<FVEC>(frow + x * fsx, dx, dy);
    k[j] = coords_at(x, y, dx, dy, H, W);
  }
#pragma unroll
  for (int j = 0; j < K3_PPT; ++j) {
    const int p = t + j * nt;
    const T* r0 = src + (int64_t)k[j].y0 * isy;
    const T* r1 = src + (int64_t)k[j].y1 * isy;
    const int a = k[j].x0 * isx, b = k[j].x1 * isx;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float v = blend4(load_f(r0 + a + c), load_f(r0 + b + c), load_f(r1 + a + c),
                             load_f(r1 + b + c), k[j].fx, k[j].fy, k[j].gx, k[j].gy);
      if (p < npx) store_f(stage + p * C + c, v);
    }
  }
  __syncthreads();
  T* dst = out + (((int64_t)n * H + y) * W + x0) * C;
  const int span = npx * C;
  int i = t;
  if (vec_store) {
    constexpr int V = 16 / sizeof(T);
    const int nv = span / V;
    for (; i < nv; i += nt)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(stage)[i];
    i = nv * V + t;
  }
  for (; i < span; i += nt) dst[i] = stage[i];
}

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

template <typename T, typename F, int CT>
void launch_k3_c(const void* img, Strides is, const void* flow, Strides fs,
                 void* out, int H, int W, int C, dim3 grid, int threads,
                 int flow_vec, int vec_store, cudaStream_t s) {
  const size_t stage = (size_t)threads * K3_PPT * C * sizeof(T);
  const T* im = static_cast<const T*>(img);
  const F* fl = static_cast<const F*>(flow);
  T* o = static_cast<T*>(out);
  if (flow_vec) {
    warp_nhwc_k3_kernel<T, F, CT, true><<<grid, threads, stage, s>>>(
        im, is, fl, fs, o, H, W, C, vec_store);
  } else {
    warp_nhwc_k3_kernel<T, F, CT, false><<<grid, threads, stage, s>>>(
        im, is, fl, fs, o, H, W, C, vec_store);
  }
}

template <typename T, typename F>
int launch_k3(const void* img, Strides is, const void* flow, Strides fs,
              void* out, int N, int H, int W, int C, int tiles, int threads,
              int ppt, int flow_vec, int vec_store, cudaStream_t s) {
  if (ppt != K3_PPT || threads < 1 || threads > K3_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles, H, N);
  if (C == 3) {
    launch_k3_c<T, F, 3>(img, is, flow, fs, out, H, W, C, grid, threads, flow_vec,
                         vec_store, s);
  } else {
    launch_k3_c<T, F, 0>(img, is, flow, fs, out, H, W, C, grid, threads, flow_vec,
                         vec_store, s);
  }
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
// image's type.  K3: the geometry from the wrapper (ops/cuda/warp_nhwc.py
// k3_plan): a grid of (tiles, H, N) blocks of `threads` threads, `ppt`
// pixels a thread (refused unless it is K3_PPT); `flow_vec`: one load per
// flow pair; `vec_store`: 16-byte stores.  K4: `vec`: 16-byte loads and
// stores, which the caller allows only where C, the image's strides and
// its address are multiples of 16 bytes.  Returns the launch's
// cudaError_t.
#define RIFE_NHWC_ENTRIES(SUFFIX, T)                                           \
  extern "C" int warp_nhwc_k3_##SUFFIX(                                        \
      const void* img, int64_t isn, int64_t isy, int64_t isx,                  \
      const void* flow, int64_t fsn, int64_t fsy, int64_t fsx, void* out,      \
      int N, int H, int W, int C, int flow_is_bf16, int tiles, int threads,    \
      int ppt, int flow_vec, int vec_store, void* stream) {                    \
    const Strides is{isn, isy, isx}, fs{fsn, fsy, fsx};                        \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                        \
    return flow_is_bf16                                                        \
               ? launch_k3<T, __nv_bfloat16>(img, is, flow, fs, out, N, H, W,  \
                                             C, tiles, threads, ppt, flow_vec, \
                                             vec_store, s)                     \
               : launch_k3<T, float>(img, is, flow, fs, out, N, H, W, C,       \
                                     tiles, threads, ppt, flow_vec, vec_store, \
                                     s);                                       \
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
