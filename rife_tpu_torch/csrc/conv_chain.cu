// One stage of the IFBlock convblock chain, on the zero-bordered flat layout:
//   dst = bf16(PReLU(conv3x3(src, W) + b, alpha))            (stages 0..S-2)
//   out = bf16(float(bf16(PReLU(conv3x3(src, W) + b))) + x)  (the last stage)
// with zero padding 1, C -> C channels.  ops/conv_chain.py launches it once
// per stage (8 for an IFBlock), ping-ponging between two flat buffers.
//
// Replaces the TPU kernels tools/r3_exp50_pallasconv.py:pallas_core (:86,
// kernel _kernel: 9 per-tap MXU products over a VMEM-resident padded
// activation) and pallas_core_v2 (:165, kernel _kernel2b: the 9 taps
// lane-concatenated into one K = 9*Cp product).  Both compute the same
// function, rife_tpu's ifblock_conv_core inner loop, and this kernel keeps
// their formulation: the activation is stored zero-bordered as a flat
// matrix of N*(H+2)*(W+2) rows, so tap t of output row m is input row
// m + off_t, off_t = (dy-1)(W+2) + (dx-1), and the border rows, written as
// 0 by every stage, are the next stage's padding.  The VMEM residency is
// not carried over: the flat buffers live in device memory and the 50 MB L2.
// Rows are LD channels apart, LD = C rounded up to 64, so that every row
// starts on a 128-byte line; the products read the first C8 channels (C
// rounded up to 8) rounded up to a k16 slice, and the channels from C up to
// there are zero.
//
// Rounding: bf16 products are exact in f32 and summed in f32 by the tensor
// cores; bias and PReLU in f32; one rounding to bf16; on the last stage
// the residual is added in f32 and rounded once.  So a stage differs from
// the plain version (ops/conv_chain.py conv_chain_ref) only by the order of
// the f32 sum.
//
// Bound: tensor-core operations (2*9*C flops per byte of activation, far
// above the H100's ~295 per byte of device memory); in practice also the
// L2 -> shared memory traffic of the taps' boxes and the epilogue, which
// does not overlap the products (tools/conv_chain.py --profile).  Design,
// for Hopper:
// - a tile is BM = 128 consecutive flat rows x BN output channels; a k-step
//   is one (tap, 64-channel chunk).  A is one TMA box of 136 rows x 64
//   channels at row m0 + (dy-1)(W+2) - 1 (rows outside the buffer arrive as
//   zeros) that serves the three taps of kernel row dy: tap dx's operand
//   starts dx rows into it (the swizzle follows the address, so any row
//   start works).  B is one box of BN weight rows x the same 64 channels.
//   Both are 128-byte swizzled, as wgmma reads them (a tap's last chunk,
//   where it is 32 channels or fewer: 32-channel boxes, 64-byte swizzle);
// - one producer thread issues the boxes into two rings (A boxes, B boxes)
//   guarded by full/empty mbarriers; two consumer warpgroups (64 rows each)
//   run wgmma.mma_async m64 x BN x k16 (bf16 in, f32 accumulators in
//   registers), straight-line per k-step (KT slices in a tap's last chunk),
//   one wgmma group in flight; setmaxnreg moves registers from the
//   producer warpgroup to the consumers;
// - a persistent grid of at most one block per SM walks the tiles, so the
//   producer loads the next tile while the consumers run the epilogue;
// - epilogue per consumer warpgroup: bias and slope in shared memory, PReLU,
//   bf16, into a 128-byte-swizzled staging tile (64 rows x SW channels, SW =
//   BN rounded up to 64; border rows 0); an inner stage's tile leaves by TMA
//   stores that overlap the next tile's products; on the last stage the
//   residual rows arrive in the staging tile by TMA first, are added in f32,
//   and a storer warp of the producer warpgroup writes the interior rows to
//   the caller's contiguous (N, H, W, C) output.
// BN is the wgmma width: 240, 152, 96 for the served C = 240, 150, 90, 16
// for small C, and 128 (several tiles along N) for C8 over 240.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;               // flat rows per tile
constexpr int BK = 64;                // channels per box: one 128-byte swizzled row
constexpr int THREADS = 384;          // producer warpgroup + 2 consumer warpgroups
constexpr int A_ROWS = BM + 8;        // an A box: the tile's rows, one before, one after
constexpr int A_BYTES = A_ROWS * BK * 2;  // 17 KB
constexpr int BOX_BYTES = 64 * BK * 2;  // a staging box: 64 rows x 64 channels
constexpr int SMEM_MAX = 232448;      // a block's shared memory on an H100
constexpr int MAX_RING = 8;
constexpr int STORE_UNROLL = 4;
// Built with -DCONV_CHAIN_PROFILE=1, the stage kernel adds clock64 marks
// (rife_tpu_torch.tools.conv_chain --profile); the served build has none.
#ifndef CONV_CHAIN_PROFILE
#define CONV_CHAIN_PROFILE 0
#endif
constexpr bool PROFILE = CONV_CHAIN_PROFILE != 0;
// Per block: producer cycles waiting for a free slot, consumer cycles
// waiting for a full one, in the products, in the epilogue, in all; the
// block's nanoseconds (globaltimer) and tiles; the last stage's first
// storer warp's cycles storing, and its end; the epilogue's parts: the
// last products' wait, the wait for a free staging tile, the fragments'
// pass, the TMA stores' issue.  Consumer marks are those of the first
// consumer warpgroup's first thread.
constexpr int PROF_FIELDS = 13;

// Shared memory: a ring of NA A boxes (each serves the three taps of one
// kernel row dy and channel chunk), a ring of NB B boxes (one per tap and
// chunk), two staging tiles, bias and slopes, mbarriers (16 bytes a ring
// slot, 32 for the rest).
template <int BN>
struct Cfg {
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int SW = (BN + BK - 1) / BK * BK;  // staging width
  static constexpr int STAGING_BYTES = 2 * 64 * SW * 2;
  static constexpr int EPI_BYTES = 2 * 2 * BN * 4 + 4 * 8;
  static constexpr int FIXED = 1024 + STAGING_BYTES + EPI_BYTES;  // 1024: alignment slack
  static constexpr int NA = BN > 192 ? 2 : 3;
  static constexpr int FIT = (SMEM_MAX - FIXED - NA * (A_BYTES + 16)) / (B_BYTES + 16);
  static constexpr int NB = FIT < MAX_RING ? FIT : MAX_RING;
  static constexpr int SMEM = FIXED + NA * (A_BYTES + 16) + NB * (B_BYTES + 16);
  static_assert(NB >= 2 && SMEM <= SMEM_MAX, "rings do not fit");
  static_assert(BN % 8 == 0 && BN <= 256, "wgmma width");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// Byte offset of (row r, channel c) in a staging tile: 64-channel boxes of
// 64 rows x 128 bytes, the 16-byte chunks of row r XORed with r % 8 (TMA's
// 128-byte swizzle).  A warp's fragment pairs (8 rows x 4 pairs of one
// chunk) then fall on 32 distinct banks.
__device__ __forceinline__ uint32_t stage_off(int r, int c) {
  return (c >> 6) * BOX_BYTES + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// --- mbarriers and TMA ---------------------------------------------------

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits for the phase of parity `parity` to complete.  A wait of seconds
// means the ring lost a phase: trap (a launch failure the caller sees)
// rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (++spins % 4096 == 0) {
      const uint64_t now = globaltimer();
      if (t0 == 0) t0 = now;
      else if (now - t0 > 4000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Shared -> global box; rows and channels outside the tensor are dropped.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The committed stores have read their shared memory (READ) or are done.
template <bool READ>
__device__ __forceinline__ void bulk_wait_all() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's generic shared-memory accesses before later TMA
// (async proxy) accesses of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// --- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major tile in the swizzle TMA
// writes: 128-byte rows (64 channels, 128-byte swizzle, 8-row groups 1024
// bytes apart) or, NARROW, 64-byte rows (32 channels, 64-byte swizzle,
// groups 512 bytes apart); the leading offset is unused for these layouts
// (1), the base aligned to the group (base offset 0).  32 bytes on the
// address step to the next k16 slice of the rows.
template <bool NARROW>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((NARROW ? 512 : 1024) >> 4) << 32) |
         ((uint64_t)(NARROW ? 2 : 1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products (wgmma writes them behind its back).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16, descriptor da) * B (16 x BN, descriptor db), bf16 in,
// f32 accumulators: thread t of the warpgroup holds rows 16 (t / 32) +
// (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1) as
// d[4 j + 2 h + e].  scale_d = 0 discards the old d.
template <int BN>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ static __forceinline__ void mma(float (&d)[8], uint64_t da, uint64_t db,
                                             uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<96> {
  __device__ static __forceinline__ void mma(float (&d)[48], uint64_t da, uint64_t db,
                                             uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db,
                                             uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<152> {
  __device__ static __forceinline__ void mma(float (&d)[76], uint64_t da, uint64_t db,
                                             uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %78, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75"
        "}, %76, %77, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<240> {
  __device__ static __forceinline__ void mma(float (&d)[120], uint64_t da, uint64_t db,
                                             uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %122, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n240k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119"
        "}, %120, %121, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// --- the stage kernel ----------------------------------------------------

// Division of 0 <= n < 2^31 by a fixed d by one multiply:
// floor(n / d) = (n * m) >> sh with sh = 31 + ceil(log2 d),
// m = floor(2^sh / d) + 1 (the error n (m d - 2^sh) / (d 2^sh) stays
// below 2^-ceil(log2 d) <= 1 / d).
struct FastDiv {
  unsigned long long m;
  int sh;
};

FastDiv fast_div(int d) {
  int s = 0;
  while ((1ll << s) < d) ++s;
  return {(unsigned long long)((1ull << (31 + s)) / d + 1), 31 + s};
}

__device__ __forceinline__ int divide(int n, FastDiv f) {
  return (int)(((unsigned long long)n * f.m) >> f.sh);
}

struct StageArgs {
  __nv_bfloat16* out;        // the (N, H, W, C) output (last stage)
  const float* bias;         // this stage's (NP,) biases and slopes, zero-padded
  const float* alpha;
  int R, H, W, C, NP;        // flat rows, image, channels, padded output channels
  int n_tiles, tiles, kc;    // tiles along N, all tiles, 64-channel chunks per tap
  int b_row0;                // this stage's first weight row: stage * 9 * NP
  int last;
  FastDiv by_plane, by_row;  // division by (H+2)(W+2) and by W+2
  unsigned long long* prof;  // PROF_FIELDS per block (profiled build only)
};

// One k-step's products: N k16 slices of the A and B boxes at a_addr and
// b_addr (64- or, NARROW, 32-channel rows); `first` (the tile's first
// slice) discards the old accumulators.  The descriptors are ready before
// the fence, so that nothing writes a register wgmma reads between it and
// the products.
template <int N, int BN, bool NARROW>
__device__ __forceinline__ void mma_step(float (&acc)[BN / 2], uint32_t a_addr,
                                         uint32_t b_addr, bool first) {
  uint64_t da[N], db[N];
  uint32_t scale[N];
#pragma unroll
  for (int kk = 0; kk < N; ++kk) {
    da[kk] = smem_desc<NARROW>(a_addr + 32 * kk);
    db[kk] = smem_desc<NARROW>(b_addr + 32 * kk);
    scale[kk] = first && kk == 0 ? 0u : 1u;
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N; ++kk) Wgmma<BN>::mma(acc, da[kk], db[kk], scale[kk]);
  wgmma_commit();
}

// The output pixel of flat row m: its index in (N, H, W) for an interior
// row, -1 on the border, -2 past the last row.
__device__ __forceinline__ int row_info(const StageArgs& p, int m) {
  if (m >= p.R) return -2;
  const int img = divide(m, p.by_plane), r = m - img * (p.H + 2) * (p.W + 2);
  const int py = divide(r, p.by_row), px = r - py * (p.W + 2);
  return py >= 1 && py <= p.H && px >= 1 && px <= p.W ? (img * p.H + py - 1) * p.W + px - 1
                                                      : -1;
}

// Block of 384 threads.  Warpgroup 0: warp 0's first thread issues the TMA
// loads; on the last stage warps 1 and 2 load the residual rows into
// consumer warpgroup 1's and 2's staging tiles and store what those leave
// there.  KT: k16 slices of a tap's last channel chunk, so every k-step's
// products are straight-line code; a last chunk of 1 or 2 slices is loaded
// as 32-channel boxes (tm_an, tm_bn), so that its pad channels are not moved.
// Maps: tm_a the source rows (boxes 136 x 64), tm_b the weights (BN x 64),
// tm_o the destination rows and tm_x the chain's input rows (64 x 64).
template <int BN, int KT>
__global__ void __launch_bounds__(THREADS, 1)
conv_stage_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b,
                  const __grid_constant__ CUtensorMap tm_an,
                  const __grid_constant__ CUtensorMap tm_bn,
                  const __grid_constant__ CUtensorMap tm_o,
                  const __grid_constant__ CUtensorMap tm_x, const StageArgs p) {
  using K = Cfg<BN>;
  constexpr bool NARROW = KT <= 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sA = smem;
  uint8_t* sB = sA + K::NA * A_BYTES;
  uint8_t* stg = sB + K::NB * K::B_BYTES;  // two staging tiles, 1024-aligned
  float* epi = reinterpret_cast<float*>(stg + K::STAGING_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(epi + 4 * BN);
  const uint32_t full_a = smem_u32(bars), empty_a = full_a + 8 * K::NA;
  const uint32_t full_b = empty_a + 8 * K::NA, empty_b = full_b + 8 * K::NB;
  const uint32_t staged0 = empty_b + 8 * K::NB, resid0 = staged0 + 16;
  constexpr int STAGING1 = 64 * K::SW * 2;  // one warpgroup's staging tile

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid & 127) >> 5, lane = tid & 31;
  const long long t_start = PROFILE ? clock64() : 0;
  const uint64_t ns_start = PROFILE ? globaltimer() : 0;
  if (tid == 0) {
    for (int s = 0; s < K::NA; ++s) {
      mbar_init(full_a + 8 * s, 1);   // the producer's expect_tx arrival + bytes
      mbar_init(empty_a + 8 * s, 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < K::NB; ++s) {
      mbar_init(full_b + 8 * s, 1);
      mbar_init(empty_b + 8 * s, 8);
    }
    for (int g = 0; g < 2; ++g) {
      mbar_init(staged0 + 8 * g, 128);  // every thread of consumer warpgroup g
      mbar_init(resid0 + 8 * g, 1);     // its storer's expect_tx arrival + bytes
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::: "memory");
    if (tid == 0) {
      // Producer: every box of the block's tiles, in order.
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_b))
                   : "memory");
      const int wp = p.W + 2;
      int sa = 0, sb = 0;
      uint32_t pha = 0, phb = 0;
      long long waited = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int mt = tile / p.n_tiles;
        const int m0 = mt * BM, n0 = (tile - mt * p.n_tiles) * BN;
        for (int dy = 0; dy < 3; ++dy) {
          for (int c = 0; c < p.kc; ++c) {
            // A narrow (32-channel) chunk moves half the bytes of a box.
            const bool narrow = NARROW && c == p.kc - 1;
            long long t0 = PROFILE ? clock64() : 0;
            mbar_wait(empty_a + 8 * sa, pha ^ 1);
            if (PROFILE) waited += clock64() - t0;
            mbar_expect_tx(full_a + 8 * sa, narrow ? A_BYTES / 2 : A_BYTES);
            tma_load_2d(smem_u32(sA + sa * A_BYTES), narrow ? &tm_an : &tm_a, c * BK,
                        m0 + (dy - 1) * wp - 1, full_a + 8 * sa);
            if (++sa == K::NA) {
              sa = 0;
              pha ^= 1;
            }
            for (int dx = 0; dx < 3; ++dx) {
              t0 = PROFILE ? clock64() : 0;
              mbar_wait(empty_b + 8 * sb, phb ^ 1);
              if (PROFILE) waited += clock64() - t0;
              mbar_expect_tx(full_b + 8 * sb, narrow ? K::B_BYTES / 2 : K::B_BYTES);
              tma_load_2d(smem_u32(sB + sb * K::B_BYTES), narrow ? &tm_bn : &tm_b, c * BK,
                          p.b_row0 + (3 * dy + dx) * p.NP + n0, full_b + 8 * sb);
              if (++sb == K::NB) {
                sb = 0;
                phb ^= 1;
              }
            }
          }
        }
      }
      if (PROFILE) p.prof[blockIdx.x * PROF_FIELDS] = waited;
    } else if (p.last && (warp == 1 || warp == 2)) {
      // Storer of consumer warpgroup g on the last stage: loads a tile's
      // residual rows into the staging tile, waits for the consumers'
      // sums there, and writes the interior rows' channels below C, a
      // row's 16-byte chunks by neighbouring lanes, 32 / chunks rows at a
      // time, the reads of STORE_UNROLL row groups before their stores.
      const int g = warp - 1;
      uint8_t* st = stg + g * STAGING1;
      const uint32_t st_u32 = smem_u32(st);
      auto load_residual = [&](int tile) {
        fence_proxy_async();  // this warp's reads of the staging tile come first
        __syncwarp();
        if (lane == 0 && tile < p.tiles) {
          const int mt = tile / p.n_tiles;
          const int mg = mt * BM + g * 64, n0 = (tile - mt * p.n_tiles) * BN;
          mbar_expect_tx(resid0 + 8 * g, K::SW / BK * BOX_BYTES);
          for (int k = 0; k < K::SW / BK; ++k)
            tma_load_2d(st_u32 + k * BOX_BYTES, &tm_x, n0 + k * BK, mg, resid0 + 8 * g);
        }
      };
      load_residual(blockIdx.x);
      uint32_t ph = 0;
      long long busy = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int mt = tile / p.n_tiles;
        const int mg = mt * BM + g * 64, n0 = (tile - mt * p.n_tiles) * BN;
        const int info_lo = row_info(p, mg + lane), info_hi = row_info(p, mg + 32 + lane);
        const int ncol = min(BN, p.C - n0);
        const int chunks = (ncol + 7) / 8, rows = 32 / chunks;
        const int lr = lane / chunks, q = (lane - lr * chunks) * 8;
        mbar_wait(staged0 + 8 * g, ph);
        ph ^= 1;
        const long long t0 = PROFILE ? clock64() : 0;
        for (int r0 = 0; r0 < 64; r0 += STORE_UNROLL * rows) {
          int info[STORE_UNROLL];
          uint4 v[STORE_UNROLL];
#pragma unroll
          for (int u = 0; u < STORE_UNROLL; ++u) {
            const int r = r0 + u * rows + lr;
            const int lo = __shfl_sync(0xffffffffu, info_lo, r & 31);
            const int hi = __shfl_sync(0xffffffffu, info_hi, r & 31);
            info[u] = lr < rows && r < 64 ? (r < 32 ? lo : hi) : -1;
            if (info[u] >= 0) v[u] = *reinterpret_cast<const uint4*>(st + stage_off(r, q));
          }
#pragma unroll
          for (int u = 0; u < STORE_UNROLL; ++u) {
            if (info[u] < 0) continue;
            const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v[u]);
            __nv_bfloat16* o = p.out + (int64_t)info[u] * p.C + n0 + q;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if ((p.C & 1) == 0) {
                if (q + 2 * i < ncol) *reinterpret_cast<__nv_bfloat162*>(o + 2 * i) = v2[i];
              } else {
                if (q + 2 * i < ncol) o[2 * i] = v2[i].x;
                if (q + 2 * i + 1 < ncol) o[2 * i + 1] = v2[i].y;
              }
            }
          }
        }
        load_residual(tile + gridDim.x);
        if (PROFILE) busy += clock64() - t0;
      }
      if (PROFILE && g == 0 && lane == 0) {
        p.prof[blockIdx.x * PROF_FIELDS + 7] = busy;
        p.prof[blockIdx.x * PROF_FIELDS + 8] = clock64() - t_start;
      }
    }
    return;
  }

  // Consumers: warpgroup g computes rows 64 g .. 64 g + 63 of each tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
  const int g = wg - 1, t = tid & 127;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  uint8_t* st = stg + g * STAGING1;
  const uint32_t st_u32 = smem_u32(st);
  float* s_bias = epi + g * 2 * BN;
  float* s_slope = s_bias + BN;
  // Staging channels BN .. SW - 1 stay zero: an inner stage's TMA stores
  // write them as the pad channels of the next stage's input.
  if constexpr (K::SW > BN) {
    constexpr int PAD = K::SW - BN;
    for (int i = t; !p.last && i < 64 * PAD; i += 128)
      *reinterpret_cast<__nv_bfloat16*>(st + stage_off(i / PAD, BN + i % PAD)) =
          __float2bfloat16_rn(0.0f);
  }

  int sa = 0, sb = 0, prev_a = -1, prev_b = -1, bias_n0 = -1;
  uint32_t pha = 0, phb = 0, rph = 0;
  long long t_wait = 0, t_mma = 0, t_epi = 0, n_tiles_done = 0;
  long long t_part[4] = {0, 0, 0, 0};  // the epilogue's parts
  long long t_mark = 0;
  auto mark = [&](int part) {
    if (PROFILE) {
      const long long now = clock64();
      t_part[part] += now - t_mark;
      t_mark = now;
    }
  };
  bool first = true;
  // Frees the ring slots the last committed group read (its B box, and its
  // A box if that was the box's third tap), once that group is done.
  auto release = [&]() {
    if (lane == 0) {
      if (prev_b >= 0) mbar_arrive(empty_b + 8 * prev_b);
      if (prev_a >= 0) mbar_arrive(empty_a + 8 * prev_a);
    }
  };
  // One k-step: tap dx of the A box in slot a against the next B box.
  auto tap = [&](int a, int dx, auto slices, auto narrow) {
    constexpr bool N32 = decltype(narrow)::value;
    const long long t0 = PROFILE ? clock64() : 0;
    mbar_wait(full_b + 8 * sb, phb);
    const long long t1 = PROFILE ? clock64() : 0;
    mma_step<decltype(slices)::value, BN, N32>(
        acc, smem_u32(sA + a * A_BYTES + (g * 64 + dx) * (N32 ? BK : 2 * BK)),
        smem_u32(sB + sb * K::B_BYTES), first);
    wgmma_wait<1>();  // the previous group is done
    release();
    if (PROFILE) {
      t_wait += t1 - t0;
      t_mma += clock64() - t1;
    }
    first = false;
    prev_b = sb;
    prev_a = dx == 2 ? a : -1;
    if (++sb == K::NB) {
      sb = 0;
      phb ^= 1;
    }
  };
  // The three taps of kernel row dy on one channel chunk.
  auto chunk = [&](auto slices, auto narrow) {
    const long long t0 = PROFILE ? clock64() : 0;
    mbar_wait(full_a + 8 * sa, pha);
    if (PROFILE) t_wait += clock64() - t0;
    for (int dx = 0; dx < 3; ++dx) tap(sa, dx, slices, narrow);
    if (++sa == K::NA) {
      sa = 0;
      pha ^= 1;
    }
  };
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int mt = tile / p.n_tiles;
    const int mg = mt * BM + g * 64, n0 = (tile - mt * p.n_tiles) * BN;
    first = true;
    for (int dy = 0; dy < 3; ++dy) {
      for (int c = 1; c < p.kc; ++c)
        chunk(std::integral_constant<int, BK / 16>{}, std::false_type{});
      chunk(std::integral_constant<int, KT>{}, std::integral_constant<bool, NARROW>{});
    }
    const long long t_e = PROFILE ? clock64() : 0;
    t_mark = t_e;
    wgmma_wait<0>();
    fence_acc(acc);
    release();
    prev_a = prev_b = -1;
    mark(0);

    // Epilogue.  The staging tile is free once the previous tile's TMA
    // stores have read it (inner stages) or once this tile's residual rows
    // are in it (the last stage: the storer loads them after draining).
    if (p.last) {
      mbar_wait(resid0 + 8 * g, rph);
      rph ^= 1;
    } else {
      if (t == 0) bulk_wait_all<true>();
      named_bar(1 + g);
    }
    mark(1);
    if (n0 != bias_n0) {
      for (int i = t; i < BN; i += 128) {
        s_bias[i] = p.bias[n0 + i];
        s_slope[i] = p.alpha[n0 + i];
      }
      named_bar(1 + g);
      bias_n0 = n0;
    }
    const int ra = warp * 16 + (lane >> 2);  // this thread's rows ra, ra + 8
    const bool inner0 = row_info(p, mg + ra) >= 0, inner1 = row_info(p, mg + ra + 8) >= 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + (lane & 3) * 2;
      const float b0 = s_bias[col], b1 = s_bias[col + 1];
      const float a0 = s_slope[col], a1 = s_slope[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
        v0 = v0 >= 0.0f ? v0 : v0 * a0;
        v1 = v1 >= 0.0f ? v1 : v1 * a1;
        __nv_bfloat162 y = __floats2bfloat162_rn(v0, v1);
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(st + stage_off(ra + 8 * h, col));
        if (p.last) {
          const float2 yf = __bfloat1622float2(y), xf = __bfloat1622float2(*dst);
          y = __floats2bfloat162_rn(yf.x + xf.x, yf.y + xf.y);
        } else if (!(h ? inner1 : inner0)) {
          y = __floats2bfloat162_rn(0.0f, 0.0f);
        }
        *dst = y;
      }
    }
    mark(2);
    if (p.last) {
      mbar_arrive(staged0 + 8 * g);
    } else {
      fence_proxy_async();  // the staging writes, before the TMA stores read them
      named_bar(1 + g);
      if (t == 0) {
        for (int k = 0; k < K::SW / BK; ++k)
          tma_store_2d(&tm_o, st_u32 + k * BOX_BYTES, n0 + k * BK, mg);
        bulk_commit();
      }
    }
    mark(3);
    if (PROFILE) {
      t_epi += clock64() - t_e;
      ++n_tiles_done;
    }
  }
  if (t == 0) bulk_wait_all<false>();
  if (PROFILE && g == 0 && t == 0) {
    unsigned long long* q = p.prof + blockIdx.x * PROF_FIELDS;
    q[1] = t_wait;
    q[2] = t_mma;
    q[3] = t_epi;
    q[4] = clock64() - t_start;
    q[5] = globaltimer() - ns_start;
    q[6] = n_tiles_done;
    for (int i = 0; i < 4; ++i) q[9 + i] = t_part[i];
  }
}

// One (tap, chunk) product of the stage kernel, alone: the A box at
// (c0, m0) and the B box at (c0, n0) through the same TMA, descriptors and
// wgmma, the product's rows starting dr rows into the A box (a tap dx =
// dr), the 128 x BN f32 accumulators written to out.  For the card's tests
// of the building blocks.
template <int BN>
__global__ void __launch_bounds__(256, 1)
tile_product_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_b, float* __restrict__ out,
                    int m0, int n0, int c0, int nk, int dr) {
  using K = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sA = align1024(smem_raw);
  uint8_t* sB = sA + A_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sB + K::B_BYTES);
  const uint32_t b = smem_u32(bar);
  const int tid = threadIdx.x, g = tid / 128, warp = (tid & 127) >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(b, A_BYTES + K::B_BYTES);
    tma_load_2d(smem_u32(sA), &tm_a, c0, m0, b);
    tma_load_2d(smem_u32(sB), &tm_b, c0, n0, b);
  }
  mbar_wait(b, 0);
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  fence_acc(acc);
  const uint64_t da = smem_desc<false>(smem_u32(sA + (g * 64 + dr) * 2 * BK));
  const uint64_t db = smem_desc<false>(smem_u32(sB));
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    if (kk < nk) Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk, kk != 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  const int r0 = g * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        out[(r0 + 8 * h) * BN + j * 8 + (lane & 3) * 2 + e] = acc[4 * j + 2 * h + e];
}

// --- host side -----------------------------------------------------------

// cuTensorMapEncodeTiled is a driver-API function; the library links only
// the runtime, so it is reached through the runtime's driver entry point.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 matrix of `rows` rows of `ld` elements (a multiple of 64) as
// boxes of box_rows x 64 channels, 128-byte swizzled, or (narrow) x 32,
// 64-byte swizzled; rows outside it read as zeros and are dropped on a
// store.  Built at every call (a cached map would outlive its tensor).
// 0, or -CUresult.
int encode_rows(CUtensorMap* map, const void* base, int64_t rows, int ld, int box_rows,
                bool narrow = false) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return -(int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)ld, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)(narrow ? BK / 2 : BK), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        narrow ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// Above 48 KB of shared memory a kernel must ask for it; set once per
// kernel, on its first (uncaptured) launch.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

struct Maps {
  CUtensorMap a, b, an, bn, o, x;
};

template <int BN, int KT>
int launch_stage(const Maps& m, const StageArgs& p, int grid, cudaStream_t stream) {
  static bool attr = false;
  if (const int e = allow_smem(conv_stage_kernel<BN, KT>, Cfg<BN>::SMEM, attr)) return e;
  conv_stage_kernel<BN, KT><<<grid, THREADS, Cfg<BN>::SMEM, stream>>>(m.a, m.b, m.an, m.bn,
                                                                        m.o, m.x, p);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_width(const Maps& m, const StageArgs& p, int kt, int grid, cudaStream_t stream) {
  if constexpr (BN == 16) {  // C8 <= 16: one slice
    return kt == 1 ? launch_stage<16, 1>(m, p, grid, stream) : (int)cudaErrorInvalidValue;
  } else {
    switch (kt) {
      case 1: return launch_stage<BN, 1>(m, p, grid, stream);
      case 2: return launch_stage<BN, 2>(m, p, grid, stream);
      case 3: return launch_stage<BN, 3>(m, p, grid, stream);
      case 4: return launch_stage<BN, 4>(m, p, grid, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
}

template <int BN>
int launch_product(const CUtensorMap& ta, const CUtensorMap& tb, float* out, int m0, int n0,
                   int c0, int nk, int dr, cudaStream_t stream) {
  constexpr int smem = 1024 + A_BYTES + Cfg<BN>::B_BYTES + 16;
  static bool attr = false;
  if (const int e = allow_smem(tile_product_kernel<BN>, smem, attr)) return e;
  tile_product_kernel<BN><<<1, 256, smem, stream>>>(ta, tb, out, m0, n0, c0, nk, dr);
  return (int)cudaGetLastError();
}

}  // namespace

// One stage.  src, xin (the chain's input) and an inner stage's dst: flat
// (N (H+2) (W+2), LD) bf16, LD a multiple of 64, of which the products read
// the first C8 columns rounded up to 16 (the columns from C on zero, and
// written so); the last stage's dst: the contiguous (N, H, W, C) output.
// w: (stages, 9, NP, LD) bf16, b and a: (stages, NP) f32, zero-padded past
// C; BN one of 16, 96, 128, 152, 240 with NP a multiple of it; grid: blocks
// of the persistent schedule; prof: grid x PROF_FIELDS counters in a
// profiled build, else unused.  0, a cudaError_t, or -CUresult of a refused
// tensor map.
extern "C" int conv_chain_stage_bf16(const void* src, void* dst, const void* xin,
                                     const void* w, const void* b, const void* a, int N,
                                     int H, int W, int C, int C8, int LD, int BN, int NP,
                                     int stages, int stage, int last, int grid, void* prof,
                                     void* stream) {
  const int64_t R = (int64_t)N * (H + 2) * (W + 2);
  if (R >= ((int64_t)1 << 31) - BM || C8 % 8 || LD % BK || LD < C8 || NP % BN || C > C8 ||
      stage >= stages || (int64_t)stages * 9 * NP >= ((int64_t)1 << 31) || grid < 1 ||
      (PROFILE && !prof))
    return (int)cudaErrorInvalidValue;
  Maps m;
  if (const int e = encode_rows(&m.a, src, R, LD, A_ROWS)) return e;
  if (const int e = encode_rows(&m.b, w, (int64_t)stages * 9 * NP, LD, BN)) return e;
  if (const int e = encode_rows(&m.an, src, R, LD, A_ROWS, true)) return e;
  if (const int e = encode_rows(&m.bn, w, (int64_t)stages * 9 * NP, LD, BN, true)) return e;
  if (const int e = encode_rows(&m.o, last ? xin : dst, R, LD, 64)) return e;
  if (const int e = encode_rows(&m.x, xin, R, LD, 64)) return e;
  const int m_tiles = (int)((R + BM - 1) / BM);
  const int kc = (C8 + BK - 1) / BK;
  const StageArgs p{static_cast<__nv_bfloat16*>(dst),
                    static_cast<const float*>(b) + (int64_t)stage * NP,
                    static_cast<const float*>(a) + (int64_t)stage * NP,
                    (int)R, H, W, C, NP, NP / BN, m_tiles * (NP / BN), kc, stage * 9 * NP, last,
                    fast_div((H + 2) * (W + 2)), fast_div(W + 2),
                    static_cast<unsigned long long*>(prof)};
  const auto st = static_cast<cudaStream_t>(stream);
  const int kt = (C8 - BK * (kc - 1) + 15) / 16;  // k16 slices of the last chunk
  switch (BN) {
    case 16: return launch_width<16>(m, p, kt, grid, st);
    case 96: return launch_width<96>(m, p, kt, grid, st);
    case 128: return launch_width<128>(m, p, kt, grid, st);
    case 152: return launch_width<152>(m, p, kt, grid, st);
    case 240: return launch_width<240>(m, p, kt, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One (tap, chunk) product: out (128, BN) f32 = A[m0 + dr .. m0 + dr + 127,
// c0 .. c0 + 63] x B[n0 .. n0 + BN - 1, same channels]^T over the channels
// below C8, A (a_rows, LD) and B (b_rows, LD) bf16, LD a multiple of 64,
// rows outside them zero, 0 <= dr <= 8; channels from C8 rounded up to 16
// on are not read.
extern "C" int conv_chain_tile_product_bf16(const void* a, int a_rows, const void* b,
                                            int b_rows, int C8, int LD, int BN, int m0,
                                            int n0, int c0, int dr, void* out, void* stream) {
  if (C8 % 8 || LD % BK || LD < C8 || c0 < 0 || c0 >= C8 || c0 % BK || dr < 0 ||
      dr > A_ROWS - BM)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (const int e = encode_rows(&ta, a, a_rows, LD, A_ROWS)) return e;
  if (const int e = encode_rows(&tb, b, b_rows, LD, BN)) return e;
  const int nk = ((C8 - c0 < BK ? C8 - c0 : BK) + 15) / 16;
  float* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (BN) {
    case 16: return launch_product<16>(ta, tb, o, m0, n0, c0, nk, dr, st);
    case 96: return launch_product<96>(ta, tb, o, m0, n0, c0, nk, dr, st);
    case 128: return launch_product<128>(ta, tb, o, m0, n0, c0, nk, dr, st);
    case 152: return launch_product<152>(ta, tb, o, m0, n0, c0, nk, dr, st);
    case 240: return launch_product<240>(ta, tb, o, m0, n0, c0, nk, dr, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

namespace {
template <int BN>
int stage_config(int* out) {
  out[0] = Cfg<BN>::SMEM;
  out[1] = Cfg<BN>::NA;
  out[2] = Cfg<BN>::NB;
  return 0;
}
}  // namespace

// The stage kernel at width BN: dynamic shared memory, A and B ring slots.
extern "C" int conv_chain_stage_config(int BN, int* out) {
  switch (BN) {
    case 16: return stage_config<16>(out);
    case 96: return stage_config<96>(out);
    case 128: return stage_config<128>(out);
    case 152: return stage_config<152>(out);
    case 240: return stage_config<240>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}
