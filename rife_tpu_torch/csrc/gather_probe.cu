// The round-3 gather probes on Hopper: what one tap gather costs beside a
// plain arithmetic op, whether an input block can be chosen per output
// block from an index array, and the image warp with one thread per
// channel.  None of them is on a served or training path.
//
// Replaces the TPU kernels of three experiments:
// - tools/r3_exp1.py:make (K6a) and tools/r3_exp2.py:micro (K7): micro
//   below;
// - tools/r3_exp1.py:sel_kernel (K6b), whose input block came from a
//   scalar-prefetched index: select_rows below;
// - tools/r3_exp1.py:warp_budget (K6c), the v3 image warp
//   (rife_tpu/ops/pallas/warp.py:_warp_kernel) with a VMEM budget that
//   sets its channel block cb: warp_cb1 below is cb = 1; K3
//   (warp_nhwc.cu, one thread per pixel looping over the C channels) is
//   cb = C;
// - tools/r3_exp21.py:make (K8), per-element lane and sublane gathers in
//   (8, 128) tiles: tile_gather below.
// Each is held bit for bit to its plain version in
// rife_tpu_torch/ops/gather_probe.py.
//
// micro.  acc <- fma(acc, DECAY, body(fma(acc, MIX, x))) on one (8, 128)
// f32 tile, from acc = 0, steps x UNROLL times.  Bound: latency, by
// design: every step depends on the last, so the operations (a few per
// element and step, under 1% of the f32 rate) never fill the card; the
// floor is the dependent chain of one step (two FMAs, the body's
// operations and, for a gathering body, one shared-memory or shuffle
// round trip), on any number of SMs.  Block form: the tile split into the
// groups that a step's dependencies close over, each group a block of its
// own (so groups run on different SMs), each step synchronising only its
// group and never the tile:
// - a row (lane, lane2, v4row, v5row: the TPU probe's lane gathers,
//   take_along_axis on axis 1, stay within a row): 8 blocks of 128
//   threads, a thread one element; a step writes s to the row's shared
//   buffer, waits at the block's barrier and reads its taps by index.
//   One warp holding the row, 4 values a lane, with __syncwarp was slower
//   at every row body (4 random shared-memory gathers a lane a step), and
//   slower still with shuffles in place of shared memory;
// - a column (sublane: axis 0, within a column): 32 blocks of one warp, 4
//   columns, lane 8c + r holding row r of column c; a step takes its tap
//   from lane 8c + idx0 with one shuffle;
// - an element (base, mul, unpack read only their own): 32 blocks of one
//   warp, 32 elements, nothing shared.
// A row's buffer is double-buffered, so one barrier a step suffices: a
// thread writes buffer k & 1 only after every thread of the row has
// passed the barrier of step k - 1, after its reads of step k - 2.
// Roundings are the reference's (its XLA fuses both a * b + c updates
// and v4/v5 rows' first product into FMAs): __fmaf_rn there,
// __fmul_rn/__fadd_rn elsewhere, so no contraction changes them.  The TPU probe's (8,128)
// vreg layout, lane and sublane axes, become the tile's columns and rows.
// The warp form (micro_warp_kernel) keeps the whole tile in one warp's
// registers: the probe's register form.

// select_rows.  out block i = 2 * x block sel[i].  Bound: bytes (the
// selected blocks read once, the output written once).  Design: one block
// of threads per output block; it loads its own sel[i] (Hopper has no
// scalar prefetch) and copies the rows with 16-byte loads and stores.  An
// index out of range writes a NaN block and reads nothing.
//
// tile_gather.  Bound: bytes (tiles and indices read once, the output
// written once).  Design: one block of 256 threads per (8, 128) tile,
// staged in shared memory with 16-byte loads; each thread reads 4 indices
// with one load, gathers its 4 elements from shared memory and stores
// them with one store.  bcast8 is 8 compare-selects summed in the
// reference's order.  An index out of range gives NaN (bcast8: 0, as the
// reference's sum of masked rows).
//
// warp_cb1.  Bound: bytes (image, flow and output once).  What makes it
// the cb = 1 probe: every (pixel, channel) item loads its own pixel's flow
// and computes the coordinate and weights itself (the TPU's "index math x
// C") with K1's code (warp_taps.cuh), so the output is K3's bit for bit;
// K3 (warp_nhwc.cu, a thread per pixel looping over its C channels) is
// cb = C.  The design around that: a grid over (tile of the row, row,
// image), so no thread divides by H or W; a tile is tile_px pixels, the
// items of its span channels-fastest, a thread's J = 16 bytes / element
// size consecutive items, each at pixel item / C, computed as a 32-bit
// multiply-shift ((item * m) >> s, exact over a tile's items: the wrapper
// finds m and s, ops/cuda/gather_probe.py cb1_plan), so each thread has
// 4 x J independent tap loads in flight; the flow pair one 8- or 4-byte
// load where aligned; the J outputs one 16-byte store where the wrapper
// allows it (the span's start a multiple of 16 bytes), the ragged end
// element by element.  64-bit bases per image, row and tap row; 32-bit
// offsets within a row.

#include "warp_taps.cuh"

namespace {

constexpr int ROWS = 8, COLS = 128, TILE = ROWS * COLS;

enum Body { BASE, MUL, LANE, LANE2, SUBLANE, UNPACK, V4ROW, V5ROW };

template <int B>
constexpr bool kGathers =
    B == LANE || B == LANE2 || B == SUBLANE || B == V4ROW || B == V5ROW;

// An f32's bits as two f32 values: the low 16 bits moved to the top, and
// the top 16 bits.
__device__ __forceinline__ void unpack(float g, float& lo, float& hi) {
  const unsigned u = __float_as_uint(g);
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xFFFF0000u);
}

constexpr unsigned FULL = 0xffffffffu;
constexpr int GROUP = 32;  // threads a column or element block: one warp
constexpr int COLS_PER_WARP = GROUP / ROWS;  // whole columns in a warp

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

// One step's body for an element of a row: `row` the row's s in shared
// memory, t1, t2 its tap columns (clamped in range), ok whether its index
// was in range (else NaN), w and wc = 1 - w its weights.
template <int B>
__device__ __forceinline__ float row_body(const float* row, int t1, int t2, bool ok,
                                          float w, float wc) {
  const float a = ok ? row[t1] : nan_f();
  float lo, hi;
  switch (B) {
    case LANE:
      return a;
    case LANE2:
      return __fadd_rn(a, ok ? row[t2] : nan_f());
    case V4ROW:
      return __fmaf_rn(a, w, __fmul_rn(ok ? row[t2] : nan_f(), wc));
    default:  // V5ROW
      unpack(a, lo, hi);
      return __fmaf_rn(lo, w, __fmul_rn(hi, wc));
  }
}

// The row bodies: block r holds row r, a thread one element; a step
// writes s to the row's shared buffer, waits at the block's (the row's)
// barrier and reads its taps by index.
template <int B, int UNROLL>
__global__ void __launch_bounds__(COLS)
micro_row_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                 const float* __restrict__ w, float* __restrict__ out, int steps,
                 float decay, float mix) {
  __shared__ float buf[2][COLS];
  const int e = blockIdx.x * COLS + threadIdx.x;
  const int i = idx[e];
  const float xe = x[e], we = w[e], wce = __fsub_rn(1.0f, we);
  const bool ok = (unsigned)i < (unsigned)COLS;
  const int t1 = ok ? i : 0;
  const int t2 = ok ? min(i + 1, COLS - 1) : 0;  // clip(i + 1, 0, 127)
  float acc = 0.0f;
  int p = 0;
  for (int k = 0; k < steps; ++k) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float s = __fmaf_rn(acc, mix, xe);
      float* row = buf[p];
      p ^= 1;
      row[threadIdx.x] = s;
      __syncthreads();
      acc = __fmaf_rn(acc, decay, row_body<B>(row, t1, t2, ok, we, wce));
    }
  }
  out[e] = acc;
}

// The sublane body: block b holds columns 4b..4b+3, lane 8c + r the
// element (r, 4b + c); its tap is lane 8c + idx0's s.
template <int UNROLL>
__global__ void __launch_bounds__(GROUP)
micro_column_kernel(const float* __restrict__ x, const int* __restrict__ idx0,
                    float* __restrict__ out, int steps, float decay, float mix) {
  const int t = threadIdx.x;
  const int e = (t % ROWS) * COLS + COLS_PER_WARP * blockIdx.x + t / ROWS;
  const float xe = x[e];
  const int i0 = idx0[e];
  const bool ok = (unsigned)i0 < (unsigned)ROWS;
  const int src = ok ? i0 : 0;  // within the lane's 8-lane column
  float acc = 0.0f;
  for (int k = 0; k < steps; ++k) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float s = __fmaf_rn(acc, mix, xe);
      const float v = __shfl_sync(FULL, s, src, ROWS);
      acc = __fmaf_rn(acc, decay, ok ? v : nan_f());
    }
  }
  out[e] = acc;
}

// The bodies that read only their own element: block b holds elements
// 32b..32b+31, a lane one.
template <int B, int UNROLL>
__global__ void __launch_bounds__(GROUP)
micro_element_kernel(const float* __restrict__ x, float* __restrict__ out, int steps,
                     float decay, float mix, float gain) {
  const int e = blockIdx.x * GROUP + threadIdx.x;
  const float xe = x[e];
  float acc = 0.0f;
  for (int k = 0; k < steps; ++k) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float s = __fmaf_rn(acc, mix, xe);
      float b, lo, hi;
      if (B == BASE) {
        b = s;
      } else if (B == MUL) {
        b = __fmul_rn(s, gain);
      } else {  // UNPACK
        unpack(s, lo, hi);
        b = __fadd_rn(lo, hi);
      }
      acc = __fmaf_rn(acc, decay, b);
    }
  }
  out[e] = acc;
}

// The warp form: the tile in one warp's registers, lane q holding columns
// 4q..4q+3 of the 8 rows.  A lane gather takes the 4 registers of its row
// from the source lane with 4 shuffles and selects one; a sublane gather
// selects among the lane's own 8 rows; nothing goes through shared memory
// and there is no barrier.  The arithmetic is the block form's, element by
// element, so both are the plain version bit for bit.  Built for unroll 1
// only: at 32 the 32 elements' unrolled shuffles spill registers.

// Column m of a row held as 4 registers a lane (NaN for m < 0).
__device__ __forceinline__ float lane_tap(const float (&row)[4], int m) {
  const int src = m >> 2, slot = m & 3;
  const float v0 = __shfl_sync(FULL, row[0], src);
  const float v1 = __shfl_sync(FULL, row[1], src);
  const float v2 = __shfl_sync(FULL, row[2], src);
  const float v3 = __shfl_sync(FULL, row[3], src);
  const float v = slot == 0 ? v0 : slot == 1 ? v1 : slot == 2 ? v2 : v3;
  return m >= 0 ? v : __int_as_float(0x7fffffff);
}

// Row i0 of column j of the lane's 8 rows (NaN for i0 out of range).
__device__ __forceinline__ float row_tap(const float (&s)[ROWS][4], int j, int i0) {
  float v = __int_as_float(0x7fffffff);
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) v = i0 == rr ? s[rr][j] : v;
  return v;
}

template <int B>
__device__ __forceinline__ float warp_body(const float (&s)[ROWS][4], int r, int j,
                                           int m, int i0, float w, float gain) {
  float lo, hi;
  const int m2 = m < 0 ? -1 : min(m + 1, COLS - 1);  // clip(i + 1, 0, 127)
  switch (B) {
    case BASE:
      return s[r][j];
    case MUL:
      return __fmul_rn(s[r][j], gain);
    case LANE:
      return lane_tap(s[r], m);
    case LANE2:
      return __fadd_rn(lane_tap(s[r], m), lane_tap(s[r], m2));
    case SUBLANE:
      return row_tap(s, j, i0);
    case UNPACK:
      unpack(s[r][j], lo, hi);
      return __fadd_rn(lo, hi);
    case V4ROW:
      return __fmaf_rn(lane_tap(s[r], m), w,
                       __fmul_rn(lane_tap(s[r], m2), __fsub_rn(1.0f, w)));
    default:  // V5ROW
      unpack(lane_tap(s[r], m), lo, hi);
      return __fmaf_rn(lo, w, __fmul_rn(hi, __fsub_rn(1.0f, w)));
  }
}

template <int B, int UNROLL>
__global__ void __launch_bounds__(32)
micro_warp_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                  const int* __restrict__ idx0, const float* __restrict__ w,
                  float* __restrict__ out, int steps, float decay, float mix,
                  float gain) {
  const int q = threadIdx.x;
  float xr[ROWS][4], wr[ROWS][4], acc[ROWS][4];
  int m[ROWS][4], i0[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = r * COLS + 4 * q + j;
      xr[r][j] = x[e];
      wr[r][j] = w[e];
      m[r][j] = (unsigned)idx[e] < (unsigned)COLS ? idx[e] : -1;
      i0[r][j] = idx0[e];
      acc[r][j] = 0.0f;
    }
  }
  for (int k = 0; k < steps; ++k) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float s[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = __fmaf_rn(acc[r][j], mix, xr[r][j]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[r][j] = __fmaf_rn(acc[r][j], decay,
                                warp_body<B>(s, r, j, m[r][j], i0[r][j], wr[r][j], gain));
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[r * COLS + 4 * q + j] = acc[r][j];
}

template <int B, int UNROLL>
void launch_block_form(const float* x, const int* idx, const int* idx0, const float* w,
                       float* out, int steps, float decay, float mix, float gain,
                       cudaStream_t s) {
  if constexpr (B == SUBLANE) {
    micro_column_kernel<UNROLL><<<COLS / COLS_PER_WARP, GROUP, 0, s>>>(x, idx0, out, steps,
                                                                      decay, mix);
  } else if constexpr (kGathers<B>) {
    micro_row_kernel<B, UNROLL><<<ROWS, COLS, 0, s>>>(x, idx, w, out, steps, decay, mix);
  } else {
    micro_element_kernel<B, UNROLL><<<TILE / GROUP, GROUP, 0, s>>>(x, out, steps, decay,
                                                                  mix, gain);
  }
}

template <int B>
int launch_micro_body(const float* x, const int* idx, const int* idx0,
                      const float* w, float* out, int steps, int unroll, int warp,
                      float decay, float mix, float gain, cudaStream_t s) {
  if (unroll == 1 && !warp) {
    launch_block_form<B, 1>(x, idx, idx0, w, out, steps, decay, mix, gain, s);
  } else if (unroll == 32 && !warp) {
    launch_block_form<B, 32>(x, idx, idx0, w, out, steps, decay, mix, gain, s);
  } else if (unroll == 1) {
    micro_warp_kernel<B, 1><<<1, 32, 0, s>>>(x, idx, idx0, w, out, steps, decay,
                                             mix, gain);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

constexpr int COPY_THREADS = 256;

__global__ void __launch_bounds__(COPY_THREADS)
select_rows_kernel(const float4* __restrict__ x, const int* __restrict__ sel,
                   float4* __restrict__ out, int nblocks, int64_t block4) {
  const int s = sel[blockIdx.x];
  float4* dst = out + (int64_t)blockIdx.x * block4;
  if (s < 0 || s >= nblocks) {
    const float nan = __int_as_float(0x7fffffff);
    for (int64_t j = threadIdx.x; j < block4; j += COPY_THREADS)
      dst[j] = make_float4(nan, nan, nan, nan);
    return;
  }
  const float4* src = x + (int64_t)s * block4;
  for (int64_t j = threadIdx.x; j < block4; j += COPY_THREADS) {
    const float4 v = __ldg(src + j);
    dst[j] = make_float4(__fmul_rn(v.x, 2.0f), __fmul_rn(v.y, 2.0f),
                         __fmul_rn(v.z, 2.0f), __fmul_rn(v.w, 2.0f));
  }
}

enum Kind { K_LANE, K_SUBLANE, K_BCAST8 };
constexpr int TILE_THREADS = TILE / 4;

template <int K>
__device__ __forceinline__ float gather1(const float* tile, int e, int i) {
  const int r = e / COLS, l = e % COLS;
  const float nan = __int_as_float(0x7fffffff);
  if (K == K_LANE) return (unsigned)i < (unsigned)COLS ? tile[r * COLS + i] : nan;
  if (K == K_SUBLANE) return (unsigned)i < (unsigned)ROWS ? tile[i * COLS + l] : nan;
  float acc = 0.0f;
#pragma unroll
  for (int s = 0; s < ROWS; ++s) acc = __fadd_rn(acc, i == s ? tile[s * COLS + l] : 0.0f);
  return acc;
}

template <int K>
__global__ void __launch_bounds__(TILE_THREADS)
tile_gather_kernel(const float4* __restrict__ x, const int4* __restrict__ idx,
                   float4* __restrict__ y) {
  __shared__ __align__(16) float tile[TILE];
  const int t = threadIdx.x;
  const int64_t at = (int64_t)blockIdx.x * TILE_THREADS + t;
  reinterpret_cast<float4*>(tile)[t] = __ldg(x + at);
  const int4 i = __ldg(idx + at);
  __syncthreads();
  const int e = 4 * t;
  y[at] = make_float4(gather1<K>(tile, e, i.x), gather1<K>(tile, e + 1, i.y),
                      gather1<K>(tile, e + 2, i.z), gather1<K>(tile, e + 3, i.w));
}

constexpr int CB1_MAX_THREADS = 256;

struct Strides {
  int64_t n, y, x;  // element strides; the channel stride is 1
};

// Block (tile, y, n) warps the items of pixels xb .. xb + tile_px - 1 of
// row y of image n; FVEC: one load per flow pair; vec_store: 16-byte
// stores.
template <typename T, typename F, bool FVEC>
__global__ void __launch_bounds__(CB1_MAX_THREADS)
warp_cb1_kernel(const T* __restrict__ img, Strides is,
                const F* __restrict__ flow, Strides fs, T* __restrict__ out,
                int H, int W, int C, int tile_px, unsigned m, int sh, int vec_store) {
  constexpr int J = Vec<T>::V;
  const int xb = blockIdx.x * tile_px, y = blockIdx.y, n = blockIdx.z;
  const int items = min(tile_px, W - xb) * C;
  const int isy = (int)is.y, isx = (int)is.x, fsx = (int)fs.x;
  const T* src = img + n * is.n;
  const F* frow = flow + n * fs.n + (int64_t)y * fs.y;
  T* dst = out + (((int64_t)n * H + y) * W + xb) * C;
  for (int l0 = threadIdx.x * J; l0 < items; l0 += blockDim.x * J) {
    float v[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      // An item past the span's end takes its last item and stores nothing.
      const int l = min(l0 + j, items - 1);
      const int xl = (int)(((unsigned)l * m) >> sh);
      const int c = l - xl * C;
      const int x = xb + xl;
      float dx, dy;
      load_pair<FVEC>(frow + x * fsx, dx, dy);
      const Coords k = coords_at(x, y, dx, dy, H, W);
      const T* r0 = src + (int64_t)k.y0 * isy + c;
      const T* r1 = src + (int64_t)k.y1 * isy + c;
      const int a = k.x0 * isx, b = k.x1 * isx;
      v[j] = blend4(load_f(r0 + a), load_f(r0 + b), load_f(r1 + a), load_f(r1 + b), k.fx,
                    k.fy, k.gx, k.gy);
    }
    if (vec_store && l0 + J <= items) {
      Vec<T>::store(dst + l0, v);
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (l0 + j < items) store_f(dst + l0 + j, v[j]);
    }
  }
}

template <typename T, typename F>
int launch_warp_cb1(const void* img, Strides is, const void* flow, Strides fs,
                    void* out, int N, int H, int W, int C, int tiles, int threads,
                    int tile_px, unsigned m, int sh, int flow_vec, int vec_store,
                    cudaStream_t s) {
  if (threads < 1 || threads > CB1_MAX_THREADS) return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles, H, N);
  const T* im = static_cast<const T*>(img);
  const F* fl = static_cast<const F*>(flow);
  T* o = static_cast<T*>(out);
  if (flow_vec) {
    warp_cb1_kernel<T, F, true><<<grid, threads, 0, s>>>(im, is, fl, fs, o, H, W, C,
                                                         tile_px, m, sh, vec_store);
  } else {
    warp_cb1_kernel<T, F, false><<<grid, threads, 0, s>>>(im, is, fl, fs, o, H, W, C,
                                                          tile_px, m, sh, vec_store);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// micro: x, w (8, 128) f32 and idx, idx0 (8, 128) int32, contiguous; out
// (8, 128) f32.  body: 0-7 in the order base, mul, lane, lane2, sublane,
// unpack, v4row, v5row; warp 0 for the block form (unroll 1 or 32: 8, 32
// or 32 blocks of one warp by the body's groups), 1 for the warp form
// (unroll 1); decay, mix, gain the f32 constants.  Returns
// the launch's cudaError_t (cudaErrorInvalidValue for another body or
// unroll).
extern "C" int gather_probe_micro(const void* x, const void* idx,
                                  const void* idx0, const void* w, void* out,
                                  int body, int unroll, int warp, int steps,
                                  float decay, float mix, float gain,
                                  void* stream) {
  const float* xf = static_cast<const float*>(x);
  const int* i = static_cast<const int*>(idx);
  const int* i0 = static_cast<const int*>(idx0);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RIFE_MICRO_CASE(B) \
  case B:                  \
    return launch_micro_body<B>(xf, i, i0, wf, o, steps, unroll, warp, decay, mix, \
                                gain, s);
  switch (body) {
    RIFE_MICRO_CASE(BASE)
    RIFE_MICRO_CASE(MUL)
    RIFE_MICRO_CASE(LANE)
    RIFE_MICRO_CASE(LANE2)
    RIFE_MICRO_CASE(SUBLANE)
    RIFE_MICRO_CASE(UNPACK)
    RIFE_MICRO_CASE(V4ROW)
    RIFE_MICRO_CASE(V5ROW)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RIFE_MICRO_CASE
}

// select_rows: x (nblocks * block_elems) f32 and out (nsel * block_elems)
// f32, contiguous and 16-byte aligned, block_elems a multiple of 4; sel
// (nsel,) int32.
extern "C" int gather_probe_select_rows(const void* x, const void* sel,
                                        void* out, int nsel, int nblocks,
                                        int64_t block_elems, void* stream) {
  select_rows_kernel<<<nsel, COPY_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const int*>(sel),
      static_cast<float4*>(out), nblocks, block_elems / 4);
  return (int)cudaGetLastError();
}

// tile_gather: x and y (ntiles, 8, 128) f32, idx (ntiles, 8, 128) int32,
// contiguous and 16-byte aligned; kind 0 lane, 1 sublane, 2 bcast8.
extern "C" int gather_probe_tile_gather(const void* x, const void* idx, void* y,
                                        int ntiles, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* xv = static_cast<const float4*>(x);
  const int4* iv = static_cast<const int4*>(idx);
  float4* yv = static_cast<float4*>(y);
  switch (kind) {
    case K_LANE:
      tile_gather_kernel<K_LANE><<<ntiles, TILE_THREADS, 0, s>>>(xv, iv, yv);
      break;
    case K_SUBLANE:
      tile_gather_kernel<K_SUBLANE><<<ntiles, TILE_THREADS, 0, s>>>(xv, iv, yv);
      break;
    case K_BCAST8:
      tile_gather_kernel<K_BCAST8><<<ntiles, TILE_THREADS, 0, s>>>(xv, iv, yv);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// warp_cb1: image strides (isn, isy, isx) and flow strides (fsn, fsy, fsx)
// in elements, channel strides 1; out a contiguous (N, H, W, C) tensor of
// the image's type.  The geometry from the wrapper (ops/cuda/gather_probe.py
// cb1_plan): a grid of (tiles, H, N) blocks of `threads` threads, tiles of
// `tile_px` pixels, a tile's item l at pixel (l * m) >> sh; `flow_vec`: one
// load per flow pair; `vec_store`: 16-byte stores.
#define RIFE_CB1_ENTRY(SUFFIX, T)                                              \
  extern "C" int gather_probe_warp_cb1_##SUFFIX(                               \
      const void* img, int64_t isn, int64_t isy, int64_t isx,                  \
      const void* flow, int64_t fsn, int64_t fsy, int64_t fsx, void* out,      \
      int N, int H, int W, int C, int flow_is_bf16, int tiles, int threads,    \
      int tile_px, unsigned m, int sh, int flow_vec, int vec_store,            \
      void* stream) {                                                          \
    const Strides is{isn, isy, isx}, fs{fsn, fsy, fsx};                        \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                        \
    return flow_is_bf16                                                        \
               ? launch_warp_cb1<T, __nv_bfloat16>(                            \
                     img, is, flow, fs, out, N, H, W, C, tiles, threads,       \
                     tile_px, m, sh, flow_vec, vec_store, s)                   \
               : launch_warp_cb1<T, float>(img, is, flow, fs, out, N, H, W, C, \
                                           tiles, threads, tile_px, m, sh,     \
                                           flow_vec, vec_store, s);            \
  }

RIFE_CB1_ENTRY(f32, float)
RIFE_CB1_ENTRY(bf16, __nv_bfloat16)
