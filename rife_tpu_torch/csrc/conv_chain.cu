// One stage of the IFBlock convblock chain on NHWC bf16 tensors:
//   dst = bf16(PReLU(conv3x3(src, W) + b, alpha))            (stages 0..S-2)
//   dst = bf16(float(bf16(PReLU(conv3x3(src, W) + b))) + x)  (the last stage)
// with zero padding 1, C -> C channels.  ops/conv_chain.py launches it once
// per stage (8 for an IFBlock), ping-ponging between two buffers.
//
// Replaces the TPU kernels tools/r3_exp50_pallasconv.py:pallas_core (:86,
// kernel _kernel: 9 per-tap MXU products over a VMEM-resident padded
// activation) and pallas_core_v2 (:165, kernel _kernel2b: the 9 taps
// lane-concatenated into one K = 9*Cp product).  Both compute the same
// function, rife_tpu's ifblock_conv_core inner loop; their layout choices
// (channels padded to 256 lanes in device memory, guard rows and an
// interior mask for the zero padding, ping-pong VMEM scratch) exist for the
// TPU and are not carried over: here the loads are masked at the image edge
// and the channel tails are zero-filled in shared memory.
//
// Rounding: bf16 products are exact in f32 and summed in f32 by the tensor
// cores; bias and PReLU in f32; one rounding to bf16; on the last stage
// the residual is added in f32 and rounded once.  So a stage differs from
// the plain version (ops/conv_chain.py conv_chain_ref) only by the order of
// the f32 sum.
//
// Bound: tensor-core operations.  A stage is an implicit GEMM with
// M = N*H*W output pixels, N = C output channels and K = 9*C; at the
// IFBlock widths (90-240 channels) it does 2*9*C flops per byte of
// activation it must move, far above the H100's ~295 flops per byte, so
// the design goes after the tensor cores: bf16 mma.sync.m16n8k16 with f32
// accumulators, a 3-deep cp.async pipeline of A and B tiles in shared
// memory, ldmatrix fragments.  Not yet: wgmma, TMA, a persistent
// single-launch chain, an epilogue staged through shared memory.
//
// Tiling: a block computes BM = 128 consecutive output pixels (flattened
// n, y, x) times BN output channels; 8 warps as 2 (M) x 4 (N), each
// 64 x (8 * NT).  NT, the n8 tiles of a warp, is a template parameter:
// BN = 32, 96, 160, 256 for NT = 1, 3, 5, 8 (C = 240 -> 256, 150 -> 160,
// 90 -> 96); wider C takes more blocks along y.  A K step is one tap and
// BK = 32 input channels: A is the tap-shifted pixels' channels, B the
// weights' rows (c_out) at that tap; channels at or past C, output
// channels past C and taps outside the image load as zeros.
//
// Loads: vec = 8 channels (16-byte cp.async) where C, the strides and the
// addresses allow it, 2 (4-byte cp.async; C = 150 and 90 land here) or 1
// (plain loads and shared stores) otherwise.  src is read through element
// strides of its n, y and x axes (channel stride 1); the weights are the
// packed (C, 9, C) rows of one stage; dst is a contiguous (N, H, W, C)
// tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BK = 32;
constexpr int LDS = BK + 8;  // row stride in bf16: 80 bytes, so the 8 rows
                             // of an ldmatrix phase hit 8 distinct bank groups
constexpr int NSTAGE = 3;
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;  // 64 rows per warp
constexpr int MT = WM / 16;       // m16 tiles per warp

struct Strides {
  int64_t n, y, x;  // element strides; the channel stride is 1
};

// The block's output pixels: offset of (n, y, x) in src, and y, x (y far
// outside the image for a pixel past N*H*W, so its every tap loads 0).
struct Pix {
  int64_t off;
  int y, x;
};

template <int NT>
struct Tile {
  static constexpr int BN = WARPS_N * 8 * NT;
  static constexpr int A_ELEMS = BM * LDS;
  static constexpr int B_ELEMS = BN * LDS;
  static constexpr int SMEM =
      BM * (int)sizeof(Pix) + NSTAGE * (A_ELEMS + B_ELEMS) * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy `rows` rows of BK channels into shared rows of LDS: row r's source
// run starts at base + row_off(r) (valid(r) false -> zeros); channels
// c0 + j at or past C are zeros.  VEC channels per copy.
template <int VEC, typename RowFn>
__device__ __forceinline__ void load_rows(__nv_bfloat16* sm, int rows,
                                          const __nv_bfloat16* base, int c0, int C,
                                          RowFn row_src) {
  constexpr int PER_ROW = BK / VEC;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int j = (i - r * PER_ROW) * VEC;
    int64_t off;
    const bool valid = row_src(r, off) && c0 + j < C;
    const __nv_bfloat16* g = valid ? base + off + c0 + j : base;
    __nv_bfloat16* s = sm + r * LDS + j;
    if constexpr (VEC == 8) {
      cp_async16(s, g, valid);
    } else if constexpr (VEC == 2) {
      cp_async4(s, g, valid);
    } else {
      *s = valid ? *g : __float2bfloat16_rn(0.0f);
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
conv_chain_stage_kernel(const __nv_bfloat16* __restrict__ src, Strides ss,
                        const __nv_bfloat16* __restrict__ res, Strides rs,
                        const __nv_bfloat16* __restrict__ wt,
                        const float* __restrict__ bias,
                        const float* __restrict__ alpha,
                        __nv_bfloat16* __restrict__ dst, int N, int H, int W,
                        int C, int vec, int last) {
  using T = Tile<NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  Pix* pix = reinterpret_cast<Pix*>(smem);
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem + BM * sizeof(Pix));
  __nv_bfloat16* sB = sA + NSTAGE * T::A_ELEMS;

  const int64_t M = (int64_t)N * H * W;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int co0 = blockIdx.y * T::BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  for (int r = tid; r < BM; r += THREADS) {
    const int64_t p = m0 + r;
    Pix q{0, -4, 0};
    if (p < M) {
      const int64_t hw = (int64_t)H * W;
      const int n = (int)(p / hw);
      const int rem = (int)(p - n * hw);
      q.y = rem / W;
      q.x = rem - q.y * W;
      q.off = n * ss.n + q.y * ss.y + q.x * ss.x;
    }
    pix[r] = q;
  }
  __syncthreads();

  const int kc = (C + BK - 1) / BK;  // channel chunks per tap
  const int ksteps = 9 * kc;
  const int64_t wrow = 9 * (int64_t)C;  // one output channel's weights

  auto load_step = [&](int k, int stage) {
    const int t = k / kc;
    const int c0 = (k - t * kc) * BK;
    const int dy = t / 3 - 1, dx = t % 3 - 1;
    const int64_t tap = dy * ss.y + dx * ss.x;
    auto a_row = [&](int r, int64_t& off) {
      const Pix q = pix[r];
      off = q.off + tap;
      return (unsigned)(q.y + dy) < (unsigned)H && (unsigned)(q.x + dx) < (unsigned)W;
    };
    auto b_row = [&](int r, int64_t& off) {
      off = (co0 + r) * wrow + (int64_t)t * C;
      return co0 + r < C;
    };
    __nv_bfloat16* a = sA + stage * T::A_ELEMS;
    __nv_bfloat16* b = sB + stage * T::B_ELEMS;
    if (vec == 8) {
      load_rows<8>(a, BM, src, c0, C, a_row);
      load_rows<8>(b, T::BN, wt, c0, C, b_row);
    } else if (vec == 2) {
      load_rows<2>(a, BM, src, c0, C, a_row);
      load_rows<2>(b, T::BN, wt, c0, C, b_row);
    } else {
      load_rows<1>(a, BM, src, c0, C, a_row);
      load_rows<1>(b, T::BN, wt, c0, C, b_row);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < ksteps) load_step(s, s);
    cp_async_commit();
  }

  for (int k = 0; k < ksteps; ++k) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // step k is in; every warp is done with step k - 1
    const int nk = k + NSTAGE - 1;
    if (nk < ksteps) load_step(nk, nk % NSTAGE);
    cp_async_commit();

    const __nv_bfloat16* a = sA + (k % NSTAGE) * T::A_ELEMS;
    const __nv_bfloat16* b = sB + (k % NSTAGE) * T::B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], a + (wm * WM + i * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 8);
      uint32_t bf[NT][2];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        if (j + 1 < NT) {
          uint32_t r[4];
          ldmatrix_x4(r, b + (wn * 8 * NT + j * 8 + (lane >> 4) * 8 + (lane & 7)) * LDS +
                             kk + ((lane >> 3) & 1) * 8);
          bf[j][0] = r[0];
          bf[j][1] = r[1];
          bf[j + 1][0] = r[2];
          bf[j + 1][1] = r[3];
        } else {
          ldmatrix_x2(bf[j][0], bf[j][1],
                      b + (wn * 8 * NT + j * 8 + (lane & 7)) * LDS + kk + ((lane >> 3) & 1) * 8);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: thread holds rows lane/4 and lane/4 + 8 of each m16 tile,
  // channels 2 * (lane % 4) and + 1 of each n8 tile.
  const bool pairs = (C & 1) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t p = m0 + wm * WM + i * 16 + (lane >> 2) + h * 8;
      if (p >= M) continue;
      const __nv_bfloat16* rp = res;
      if (last) {
        const int64_t hw = (int64_t)H * W;
        const int n = (int)(p / hw);
        const int rem = (int)(p - n * hw);
        const int y = rem / W;
        rp = res + n * rs.n + y * rs.y + (rem - y * W) * rs.x;
      }
      __nv_bfloat16* op = dst + p * C;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int co = co0 + wn * 8 * NT + j * 8 + (lane & 3) * 2;
        __nv_bfloat16 o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = min(co + e, C - 1);  // lanes past C compute and drop
          float v = acc[i][j][h * 2 + e] + bias[c];
          v = v >= 0.0f ? v : v * alpha[c];
          o[e] = __float2bfloat16_rn(v);
          if (last)
            o[e] = __float2bfloat16_rn(__bfloat162float(o[e]) + __bfloat162float(rp[c]));
        }
        if (pairs) {
          if (co < C) *reinterpret_cast<__nv_bfloat162*>(op + co) = __halves2bfloat162(o[0], o[1]);
        } else {
          if (co < C) op[co] = o[0];
          if (co + 1 < C) op[co + 1] = o[1];
        }
      }
    }
  }
}

template <int NT>
int launch(const __nv_bfloat16* src, Strides ss, const __nv_bfloat16* res, Strides rs,
           const __nv_bfloat16* w, const float* b, const float* a, __nv_bfloat16* dst,
           int N, int H, int W, int C, int vec, int last, cudaStream_t stream) {
  using T = Tile<NT>;
  // Above 48 KB of shared memory a kernel must ask for it; set once, on
  // the first (uncaptured) launch of each width.
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_chain_stage_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int64_t M = (int64_t)N * H * W;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((C + T::BN - 1) / T::BN));
  conv_chain_stage_kernel<NT><<<grid, THREADS, T::SMEM, stream>>>(
      src, ss, res, rs, w, b, a, dst, N, H, W, C, vec, last);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int conv_chain_stage_bf16(const void* src, int64_t sn, int64_t sy, int64_t sx,
                                     const void* res, int64_t rn, int64_t ry, int64_t rx,
                                     const void* w, const void* b, const void* a, void* dst,
                                     int N, int H, int W, int C, int vec, int last,
                                     void* stream) {
  const auto* s = static_cast<const __nv_bfloat16*>(src);
  const auto* r = static_cast<const __nv_bfloat16*>(res);
  const auto* wt = static_cast<const __nv_bfloat16*>(w);
  const auto* bias = static_cast<const float*>(b);
  const auto* alpha = static_cast<const float*>(a);
  auto* d = static_cast<__nv_bfloat16*>(dst);
  const Strides ss{sn, sy, sx}, rs{rn, ry, rx};
  const auto st = static_cast<cudaStream_t>(stream);
  if (vec != 1 && vec != 2 && vec != 8) return (int)cudaErrorInvalidValue;
  if (C <= 32) return launch<1>(s, ss, r, rs, wt, bias, alpha, d, N, H, W, C, vec, last, st);
  if (C <= 96) return launch<3>(s, ss, r, rs, wt, bias, alpha, d, N, H, W, C, vec, last, st);
  if (C <= 160) return launch<5>(s, ss, r, rs, wt, bias, alpha, d, N, H, W, C, vec, last, st);
  return launch<8>(s, ss, r, rs, wt, bias, alpha, d, N, H, W, C, vec, last, st);
}
