// W8A8 int8 convolution for Hopper (sm_90a): the per-tensor activation scale
// (K6), the activation codes (K7) and the int8 implicit-GEMM convolution with
// its dequantizing epilogue (K8), for TPU.quantize="int8" serving.
//
// Replaces: no Pallas kernel. The JAX package leaves its W8A8 conv to XLA
// (fovealseg_tpu/models/layers.py::_int8_conv, :202-218, called by
// TorchConv for convs of >= 128 input and output channels). PyTorch has no
// int8 convolution on CUDA, and the activation quantization in stock ops
// would take ~7 eager kernels per conv, so the three are written by hand.
// The scheme, bit for bit:
//
//   s_x   = max(max |x|, 1e-12) / 127                     (f32, whole tensor)
//   x_q   = int8(rint(x / s_x))                            (IEEE division,
//                                                            round half to even)
//   z     = sum over (ky, kx, c) of x_q * w_q              (int32, exact)
//   y     = cast_out(f32(z) * (s_x * s_w[n]))             (the product taken
//                                                            first)
//   y     = cast_out(y + bias[n])                          (in the output dtype)
//
// w_q and s_w are the per-output-channel weight codes and scales, made once
// on the host (ops/quant.py, models/layers.py::quantize_kernel). Every step
// uses the round-to-nearest intrinsics (__fdiv_rn, __fmul_rn, __fadd_rn,
// __int2float_rn): nvcc would otherwise contract a*b+c into one FMA, which
// rounds once where the JAX package rounds twice. In bf16 the product is
// rounded to bf16 before the bf16 bias is added, as TorchConv does.
//
// Layouts: the port runs NCHW. K7 reads the NCHW activation and writes its
// codes channels innermost ([B, H, W, C], so that one 16-byte load of K8
// holds 16 channels of one tap); the weight codes are [N, kh, kw, C]; K8
// writes NCHW in the output dtype, the layout the next layer reads.
//
// What bounds them, at the flagship's b8 shapes (640x640 canvas, 80x80
// task; 18 distinct quantized convs, 184 per call): K6 and K7 are bytes
// (one read of the activation; K7 also writes a quarter (f32) or half
// (bf16) of it as codes). K8, as M = B*Ho*Wo output pixels by N output
// channels by K = kh*kw*C, is operations (2*M*N*K over 1,979 TOPS) at every
// 3x3 stride-1 conv: C1's 960 -> 240 at 80x80 (212 GOP, 0.107 ms against
// 0.023 ms of bytes at 3.35 TB/s), 192 -> 192 at 80x80, HRNet's 128 @ 40x40,
// 256 @ 20x20 and 512 @ 10x10 (3.8 GOP each, 1.9 us) and 512 @ 20x20; it is
// bytes (the codes read once) at the 1x1 convs and the strided 3x3 ones but
// 256 -> 512 @ 20x20 and 512 @ 20x20 stride 2. Either way the small convs
// are a few microseconds of work, so launch, pipeline fill and tail count.
//
// K8's design, against what held the mma.sync kernel it replaces back:
//   * wgmma.mma_async m64nNk32 s32.s8.s8 (the only route to the int8 rate),
//     both operands K-major in shared memory in 128-byte swizzled tiles
//     (the layout the repository already has: A's rows are output pixels
//     with (ky, kx, c) innermost, B is [N, K]). Two consumer warpgroups share
//     a 128-row tile, 64 rows each; BN is 128, 192, 240 or 256, chosen per
//     shape (plan_conv), all widths the PTX ISA allows for s8, so N is never
//     padded but up to the next of them (TMA fills the missing B rows with
//     zeros). C1's N = 240 is one tile: A is gathered once, not 4 times.
//   * a ring of 4-6 stages of A (128 rows x 128 B) and B (BN rows x
//     128 B) with full and empty mbarriers instead of two cp.async stages
//     and a __syncthreads per 64-byte step. One producer warpgroup (its
//     registers lowered by setmaxnreg, the consumers' raised): its first
//     thread loads B through TMA (a tiled tensor map over [N, K] int8 with
//     128-byte swizzle, out-of-range rows and columns read as zeros; the
//     map is encoded on the host through cudaGetDriverEntryPointByVersion,
//     so the build needs no -lcuda, and cached per weight pointer and
//     shape); its 128 threads gather A, the implicit im2col of K7's codes,
//     with 16-byte cp.async into the swizzled layout: each 16-byte unit
//     finds its own tap and channel (C = 960, 192 and 144 make a 128-byte
//     chunk straddle two taps) and is zero-filled off the image, past M and
//     past K. Every A route is this one: no shape takes TMA's im2col mode.
//     A producer thread signals a stage full once its copies have landed
//     (cp.async.wait_group two stages short of the ring, then a proxy fence,
//     so that wgmma, which reads through the async proxy, sees them).
//   * split K where the tiles do not fill the card: where M tiles x N tiles
//     < 132, the K steps are split over blockIdx.z so that the grid fills
//     one wave (one block per SM: tiles x splits <= 132), with no split under
//     kMinSplitSteps steps (but the last) and at most kMaxSplits. Still one
//     launch per conv: a tile's splits are one thread-block cluster (1, 1,
//     splits). Each block puts its int32 partial in its own shared memory;
//     after a cluster barrier, block r adds the others' partials for its
//     share (1 / splits) of the tile's columns, read through distributed
//     shared memory, and runs the epilogue on those columns; a second
//     barrier keeps every block alive until the others have read it. So the
//     reduction and the output stores are spread over the splits, and
//     nothing passes between blocks through device memory: a launch needs
//     no workspace and leaves no state for the next, whatever stream it runs
//     on. Int32 sums are exact, so any split gives the same bits. At the
//     flagship's shapes the M = 800 and 3,200 convs of 3x3 split (2 to 4
//     ways), the others do not; a split tile is 128 wide.
//   * the epilogue stages the tile through shared memory channel by channel,
//     so that a warp stores consecutive pixels of one channel (NCHW) as
//     16-byte vectors where Ho*Wo allows, instead of 4-byte stores strided
//     by Ho*Wo.
// What remains: a 128 x BN tile's B (weights) is read from L2 once per M
// tile, so C1's 400 tiles move ~1.2 GB through L2; the grid is not
// persistent, so a grid of 400 tiles runs in 4 waves of 132; K7 is not
// fused into the A loads.
//
// Entry points: fovealseg_w8a8_conv2d, what serving calls, launches K6, K7
// and K8 in turn from one host call, the codes, partials and s_x in one
// workspace of the caller's; each kernel also has an entry point of its own,
// which tests and measurements call to hold it against its plain version.

#include <cuda.h>  // CUtensorMap and its enums; the entry point comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>

namespace {

// ------------------------------------------------------------------ K6

constexpr int kAbsThreads = 256;
constexpr int kAbsMaxBlocks = 1024;

// max |.| of a 16-byte chunk: 4 floats or 8 bf16 (a bf16 is the high half of
// the f32 with the same value, so the widening is exact)
template <bool kBf16>
__device__ __forceinline__ float chunk_absmax(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kBf16) {
      m = fmaxf(m, fabsf(__uint_as_float(w[i] << 16)));
      m = fmaxf(m, fabsf(__uint_as_float(w[i] & 0xffff0000u)));
    } else {
      m = fmaxf(m, fabsf(__uint_as_float(w[i])));
    }
  }
  return m;
}

template <bool kBf16>
__device__ __forceinline__ float load_abs(const void* x, long long i) {
  if (kBf16) {
    return fabsf(__bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]));
  }
  return fabsf(static_cast<const float*>(x)[i]);
}

__device__ __forceinline__ float block_max(float m) {
  __shared__ float warp_max[kAbsThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = threadIdx.x < kAbsThreads / 32 ? warp_max[threadIdx.x] : 0.f;
  if (threadIdx.x < 32) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  return m;  // valid in thread 0
}

// n elements; `chunks` 16-byte chunks from the base (0 where the base is not
// 16-byte aligned), the elements past them one by one
template <bool kBf16>
__global__ void __launch_bounds__(kAbsThreads)
absmax_partial(const void* __restrict__ x, long long n, long long chunks,
               float* __restrict__ partial) {
  constexpr int kPer = kBf16 ? 8 : 4;
  const long long stride = static_cast<long long>(gridDim.x) * kAbsThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kAbsThreads + threadIdx.x;
  float m = 0.f;
  const uint4* v = static_cast<const uint4*>(x);
  for (long long i = first; i < chunks; i += stride) m = fmaxf(m, chunk_absmax<kBf16>(v[i]));
  for (long long i = chunks * kPer + first; i < n; i += stride) m = fmaxf(m, load_abs<kBf16>(x, i));
  m = block_max(m);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

__global__ void __launch_bounds__(kAbsThreads)
absmax_final(const float* __restrict__ partial, int count, float* __restrict__ s_x) {
  float m = 0.f;
  for (int i = threadIdx.x; i < count; i += kAbsThreads) m = fmaxf(m, partial[i]);
  m = block_max(m);
  if (threadIdx.x == 0) *s_x = __fdiv_rn(fmaxf(m, 1e-12f), 127.0f);
}

int absmax_blocks(long long n) {
  const long long per_block = static_cast<long long>(kAbsThreads) * 8;
  const long long b = (n + per_block - 1) / per_block;
  return static_cast<int>(b < 1 ? 1 : (b > kAbsMaxBlocks ? kAbsMaxBlocks : b));
}

// ------------------------------------------------------------------ K7

constexpr int kQuantC = 32;   // channels per tile
constexpr int kQuantP = 64;   // pixels per tile
constexpr int kQuantThreads = 256;

template <bool kBf16>
__global__ void __launch_bounds__(kQuantThreads)
quantize_act_kernel(const void* __restrict__ x, const float* __restrict__ s_x,
                    int8_t* __restrict__ q, int c, long long hw) {
  __shared__ int8_t tile[kQuantC][kQuantP + 4];
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * kQuantC;
  const long long p0 = static_cast<long long>(blockIdx.x) * kQuantP;
  const float s = *s_x;
  const long long img = static_cast<long long>(b) * c * hw;
#pragma unroll
  for (int i = 0; i < kQuantC * kQuantP / kQuantThreads; ++i) {
    const int e = threadIdx.x + i * kQuantThreads;
    const int cy = e / kQuantP, px = e % kQuantP;
    int8_t code = 0;
    if (c0 + cy < c && p0 + px < hw) {
      const long long at = img + static_cast<long long>(c0 + cy) * hw + p0 + px;
      const float v = kBf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[at])
                            : static_cast<const float*>(x)[at];
      code = static_cast<int8_t>(static_cast<int>(rintf(__fdiv_rn(v, s))));
    }
    tile[cy][px] = code;
  }
  __syncthreads();
  // each pixel's 32 channels as 8 words of 4 codes
#pragma unroll
  for (int i = 0; i < kQuantP * (kQuantC / 4) / kQuantThreads; ++i) {
    const int e = threadIdx.x + i * kQuantThreads;
    const int px = e / (kQuantC / 4), w = e % (kQuantC / 4);
    if (p0 + px >= hw || c0 + 4 * w >= c) continue;
    const uint32_t word = static_cast<uint32_t>(static_cast<uint8_t>(tile[4 * w][px])) |
                          static_cast<uint32_t>(static_cast<uint8_t>(tile[4 * w + 1][px])) << 8 |
                          static_cast<uint32_t>(static_cast<uint8_t>(tile[4 * w + 2][px])) << 16 |
                          static_cast<uint32_t>(static_cast<uint8_t>(tile[4 * w + 3][px])) << 24;
    const long long at = (static_cast<long long>(b) * hw + p0 + px) * c + c0 + 4 * w;
    *reinterpret_cast<uint32_t*>(q + at) = word;
  }
}

// ------------------------------------------------------------------ K8

constexpr int kBM = 128;               // output pixels per tile: two warpgroups of 64 rows
constexpr int kBK = 128;               // K bytes per stage: one 128-byte swizzle row
constexpr int kRingBytes = 204800;     // the ring of stages: 200 KB of the 227 a block may take
constexpr int kMaxStages = 8;
constexpr int kProducerThreads = 128;  // warpgroup 0 loads
constexpr int kConsumerThreads = 256;  // warpgroups 1 and 2 multiply
constexpr int kConvThreads = kProducerThreads + kConsumerThreads;
constexpr int kSms = 132;              // SMs of the H100 SXM: one wave of one block each
constexpr int kMinSplitSteps = 4;      // the fewest K steps a split takes (but the last)
constexpr int kMaxSplits = 8;          // a tile's splits form one cluster: 8 blocks at most

// The planner, the one place BN and the split of K are chosen, from M, N
// and K alone. BN: the narrowest of 128, 192, 240, 256 that holds N (256
// past it), or 128 where that leaves fewer tiles than SMs (more tiles, a
// smaller partial per split; so every split tile is 128 wide). K: kBK-byte
// steps; where the tiles do not fill one wave, the fewest steps per split
// (kMinSplitSteps at least) that keep tiles x splits within one wave and
// the splits of a tile within one cluster (kMaxSplits), and as many splits
// as that takes.
struct ConvPlan {
  int bn, m_tiles, n_tiles, steps, splits, steps_per_split;
};

ConvPlan plan_conv(long long m, int n, int k) {
  ConvPlan p;
  p.bn = n <= 128 ? 128 : n <= 192 ? 192 : n <= 240 ? 240 : 256;
  p.m_tiles = static_cast<int>((m + kBM - 1) / kBM);
  p.n_tiles = (n + p.bn - 1) / p.bn;
  if (p.bn > 128 && static_cast<long long>(p.m_tiles) * p.n_tiles < kSms) {
    p.bn = 128;
    p.n_tiles = (n + 127) / 128;
  }
  p.steps = (k + kBK - 1) / kBK;
  const long long tiles = static_cast<long long>(p.m_tiles) * p.n_tiles;
  int per = p.steps;
  if (tiles < kSms) {
    per = kMinSplitSteps;
    while (per < p.steps && (tiles * ((p.steps + per - 1) / per) > kSms ||
                             (p.steps + per - 1) / per > kMaxSplits)) {
      ++per;
    }
    if (per > p.steps) per = p.steps;
  }
  p.steps_per_split = per;
  p.splits = (p.steps + per - 1) / per;
  return p;
}

struct ConvShape {
  int h, w, c, n, kh, kw, stride, pad, ho, wo, k;
  long long m;  // b * ho * wo
};

struct ConvArgs {
  ConvShape s;
  int m_tiles, steps, steps_per_split, splits;
  int out_bf16;   // the output (and bias) dtype: bf16 (1) or f32 (0)
  int vec_store;  // Ho*Wo and the output allow 16-byte stores
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* gmem, bool valid) {
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes (cp.async) ordered before async-proxy reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// one TMA box of the tensor map at (c0 innermost, c1) into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the 256 consumer threads only (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// every thread of every block of the cluster (release / acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the int4 at this block's shared address `local` in block `rank` of the cluster
__device__ __forceinline__ int4 ld_peer_int4(const void* local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// wgmma's shared-memory descriptor of a K-major tile with 128-byte swizzle:
// start address >> 4, leading offset 1 (unused by this layout), stride 1024
// bytes between 8-row atoms, layout 1 (128B swizzle). Tiles are 1024-aligned.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
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

// keeps the compiler from moving accumulator reads across wgmma's waits
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma.mma_async m64nNk32, s32 += s8 x s8, A and B from shared-memory
// descriptors (both K-major): d[4j .. 4j+3] of a thread hold, in its warp's
// 16 rows, rows lane/4 and lane/4 + 8 at columns 8j + 2 (lane % 4) + {0, 1}.
template <int N>
struct Wgmma;

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  __device__ __forceinline__ static void mma(int (&d)[96], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
          "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<240> {
  __device__ __forceinline__ static void mma(int (&d)[120], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %122, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n240k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119"
        "}, %120, %121, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
          "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
          "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
          "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(int (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
          "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
          "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
          "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
          "+r"(d[126]), "+r"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <typename OutT>
struct Epilogue;

// y = f32(z) * (s_x * s_w[n]) cast to the output dtype, then + bias[n] in
// it (a bf16 bias widened to f32 exactly: the sum of two bf16 rounded once)
template <>
struct Epilogue<float> {
  __device__ __forceinline__ static float apply(float y, bool has_bias, float bias) {
    return has_bias ? __fadd_rn(y, bias) : y;
  }
};

template <>
struct Epilogue<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 apply(float y, bool has_bias, float bias) {
    const __nv_bfloat16 r = __float2bfloat16_rn(y);
    if (!has_bias) return r;
    return __float2bfloat16_rn(__fadd_rn(__bfloat162float(r), bias));
  }
};

constexpr int kStageF32 = kBM + 4;   // staging row stride (floats): conflict-free fragment writes
constexpr int kStageBf16 = kBM + 8;  // ... (bf16); both rows 16-byte aligned

// The ring's depth for a width: as many stages of A and B as kRingBytes
// holds (6 at BN = 128, 5 at 192, 4 at 240 and 256); a producer thread
// keeps all but two of them in flight before it signals the oldest full.
template <int BN>
__host__ __device__ constexpr int conv_stages() {
  return kRingBytes / ((kBM + BN) * kBK) < kMaxStages ? kRingBytes / ((kBM + BN) * kBK)
                                                       : kMaxStages;
}

// the ring, its full and empty barriers, the tile's scales and biases
// (2 x 256 floats), 1024 bytes to align the ring
template <int BN>
__host__ __device__ constexpr int conv_smem_bytes() {
  return conv_stages<BN>() * (kBM + BN) * kBK + 16 * conv_stages<BN>() + 16 + 2048 + 1024;
}

// K8: one 128 x BN output tile, the K steps [split * steps_per_split, ...)
// of it. Grid (M tiles, N tiles, splits), 384 threads, conv_smem_bytes<BN>();
// where K is split, clusters of (1, 1, splits): a tile's splits.
template <int BN>
__global__ void __launch_bounds__(kConvThreads, 1)
int8_conv_wgmma(const __grid_constant__ CUtensorMap wmap, const int8_t* __restrict__ xq,
                const float* __restrict__ s_x, const float* __restrict__ s_w,
                const void* __restrict__ bias, void* __restrict__ out, const ConvArgs a) {
  constexpr int kABytes = kBM * kBK;
  constexpr int kBBytes = BN * kBK;
  constexpr int kStageBytes = kABytes + kBBytes;
  constexpr int kStages = conv_stages<BN>();
  constexpr int kProducerLag = kStages - 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // swizzle atoms: 1024-aligned
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + kStages * kStageBytes;  // full[kStages], then empty[kStages]
  const uint32_t empty0 = full0 + 8 * kStages;
  // s_x * s_w[n] of the tile's columns, then bias[n] as f32 (exact)
  float* scale_sm = reinterpret_cast<float*>(smem + kStages * kStageBytes + 16 * kStages);
  float* bias_sm = scale_sm + 256;

  const int tid = threadIdx.x;
  const int tile_m = blockIdx.x, tile_n = blockIdx.y, split = blockIdx.z;
  const int kt0 = split * a.steps_per_split;
  const int steps = min(a.steps, kt0 + a.steps_per_split) - kt0;
  const ConvShape& s = a.s;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, kProducerThreads + 1);  // each loader, + the TMA's expect_tx
      mbar_init(empty0 + 8 * i, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wmap))
                 : "memory");
  }
  __syncthreads();

  if (tid < kProducerThreads) {
    // ---- producer: B by TMA (thread 0), A by cp.async (all 128)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int unit = tid & 7;   // this thread's 16-byte unit of each 128-byte K row
    const int row0 = tid >> 3;  // its rows: row0 + 16 r, r < 8
    const uint32_t a_off = row0 * kBK + ((unit ^ (row0 & 7)) << 4);  // 128B swizzle
    const int howo = s.ho * s.wo;  // M < 2^31: 32-bit pixel arithmetic
    int pix[8], at[8];  // per row: the pixel index of tap (0, 0); its (iy, ix) as 2 x int16
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = tile_m * kBM + row0 + 16 * r;
      if (m < s.m) {
        const int b = m / howo;
        const int p = m - b * howo;
        const int oy = p / s.wo, ox = p - (p / s.wo) * s.wo;
        const int iy = oy * s.stride - s.pad, ix = ox * s.stride - s.pad;
        pix[r] = (b * s.h + iy) * s.w + ix;
        at[r] = static_cast<int>((static_cast<uint32_t>(iy) << 16) |
                                 (static_cast<uint32_t>(ix) & 0xffffu));
      } else {
        pix[r] = 0;
        at[r] = static_cast<int>(0x80000000u);  // iy = -32768: never on the image
      }
    }
    int k = (kt0 * kBK) + unit * 16;  // this unit's K index, its tap and channel
    int tap = k / s.c;
    int ch = k - tap * s.c;
    int ky = tap / s.kw, kx = tap - (tap / s.kw) * s.kw;
    for (int i = 0; i < steps; ++i) {
      const int stage = i % kStages;
      mbar_wait(empty0 + 8 * stage, ((i / kStages) & 1) ^ 1);
      const uint32_t stage_base = base + stage * kStageBytes;
      if (tid == 0) {
        mbar_arrive_expect_tx(full0 + 8 * stage, kBBytes);
        tma_load_2d(stage_base + kABytes, &wmap, full0 + 8 * stage, (kt0 + i) * kBK,
                    tile_n * BN);
      }
      const bool k_ok = k < s.k;
      const int tap_off = ky * s.w + kx;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int iy = (at[r] >> 16) + ky;
        const int ix = static_cast<int>(static_cast<int16_t>(at[r] & 0xffff)) + kx;
        const bool ok = k_ok && static_cast<unsigned>(iy) < static_cast<unsigned>(s.h) &&
                        static_cast<unsigned>(ix) < static_cast<unsigned>(s.w);
        const int8_t* src =
            ok ? xq + static_cast<long long>(pix[r] + tap_off) * s.c + ch : xq;
        cp_async16(stage_base + a_off + r * 16 * kBK, src, ok);
      }
      cp_async_commit();
      if (i >= kProducerLag) {
        cp_async_wait<kProducerLag>();
        fence_proxy_async();
        mbar_arrive(full0 + 8 * ((i - kProducerLag) % kStages));
      }
      k += kBK;
      ch += kBK;
      while (ch >= s.c) {
        ch -= s.c;
        if (++kx == s.kw) {
          kx = 0;
          ++ky;
        }
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    for (int i = steps > kProducerLag ? steps - kProducerLag : 0; i < steps; ++i) {
      mbar_arrive(full0 + 8 * (i % kStages));
    }
    if (a.splits > 1) {  // the consumers' two cluster barriers count every thread
      cluster_arrive();
      cluster_wait();
      cluster_arrive();
      cluster_wait();
    }
    return;
  }

  // ---- consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63 of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int ctid = tid - kProducerThreads;
  const int wg = ctid >> 7, lane = ctid & 31, warp = (ctid >> 5) & 3;
  const int n0 = tile_n * BN;
  if (ctid < BN) {  // the epilogue's per-column factors, loaded while the ring fills
    const int n = n0 + ctid;
    const bool in = n < s.n;
    scale_sm[ctid] = in ? __fmul_rn(*s_x, s_w[n]) : 0.f;
    bias_sm[ctid] = !in || !bias ? 0.f
                    : a.out_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n])
                                 : static_cast<const float*>(bias)[n];
  }
  int acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0;
  fence_regs(acc);
  for (int i = 0; i < steps; ++i) {
    const int stage = i % kStages;
    mbar_wait(full0 + 8 * stage, (i / kStages) & 1);
    const uint32_t stage_base = base + stage * kStageBytes;
    const uint64_t da = sw128_desc(stage_base + wg * 64 * kBK);
    const uint64_t db = sw128_desc(stage_base + kABytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the step before is done: its stage goes back to the producer
    if (i > 0) mbar_arrive(empty0 + 8 * ((i - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // the column chunks [j0, j1) of 8 columns are this block's to finish
  int j0 = 0, j1 = BN / 8;
  uint8_t* staging = smem;
  consumers_sync();  // both warpgroups past their last wgmma: the ring is free
  if (a.splits > 1) {
    // The tile's splits are one cluster, block `split` its rank. Each puts its
    // int32 partial in its shared memory (fragment order: chunk j of consumer
    // thread t at [j][t]), then adds the others' partials for its share of
    // the chunks, read through distributed shared memory, and finishes them.
    int4* mine = reinterpret_cast<int4*>(smem) + ctid;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mine[j * kConsumerThreads] =
          make_int4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    }
    cluster_arrive();
    cluster_wait();  // every split's partial is in place
    j0 = split * (BN / 8) / a.splits;
    j1 = (split + 1) * (BN / 8) / a.splits;
    for (int sp = 0; sp < a.splits; ++sp) {
      if (sp == split) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (j < j0 || j >= j1) continue;
        const int4 v = ld_peer_int4(mine + j * kConsumerThreads, sp);
        acc[4 * j] += v.x;
        acc[4 * j + 1] += v.y;
        acc[4 * j + 2] += v.z;
        acc[4 * j + 3] += v.w;
      }
    }
    cluster_arrive();  // done reading the others: waited for before this block exits
    staging = smem + (BN / 8) * kConsumerThreads * 16;  // past this block's partial
  }

  // ---- epilogue: dequantize into a channel-major staging tile
  float* st_f = reinterpret_cast<float*>(staging);
  __nv_bfloat16* st_h = reinterpret_cast<__nv_bfloat16*>(staging);
  const bool has_bias = bias != nullptr;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (j < j0 || j >= j1) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 8 * j + 2 * (lane & 3) + c;
      const float scale = scale_sm[col], b = bias_sm[col];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
        const float y = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + c]), scale);
        if (a.out_bf16) {
          st_h[col * kStageBf16 + row] = Epilogue<__nv_bfloat16>::apply(y, has_bias, b);
        } else {
          st_f[col * kStageF32 + row] = Epilogue<float>::apply(y, has_bias, b);
        }
      }
    }
  }
  consumers_sync();

  // ---- stores: each warp writes whole channels, consecutive pixels per lane
  const int m0 = tile_m * kBM;
  const int howo = s.ho * s.wo;
  const int c0 = 8 * j0, c1 = min(8 * j1, s.n - n0);  // this block's columns
  const int cw = ctid >> 5;                            // 0 .. 7
  if (a.vec_store) {
    // Ho*Wo is a multiple of the vector: no vector straddles two images or M
    const int e = a.out_bf16 ? 8 * (lane & 15) : 4 * lane;
    const int m = m0 + e;
    if (m < s.m) {
      const int b = m / howo;
      const long long at = static_cast<long long>(b) * s.n * howo + (m - b * howo);
      if (a.out_bf16) {
        auto* o = static_cast<__nv_bfloat16*>(out);
        for (int col = c0 + 2 * cw + (lane >> 4); col < c1; col += 16) {
          *reinterpret_cast<uint4*>(o + at + static_cast<long long>(n0 + col) * howo) =
              *reinterpret_cast<const uint4*>(st_h + col * kStageBf16 + e);
        }
      } else {
        auto* o = static_cast<float*>(out);
        for (int col = c0 + cw; col < c1; col += 8) {
          *reinterpret_cast<float4*>(o + at + static_cast<long long>(n0 + col) * howo) =
              *reinterpret_cast<const float4*>(st_f + col * kStageF32 + e);
        }
      }
    }
  } else {
    for (int e = lane; e < kBM; e += 32) {
      const int m = m0 + e;
      if (m >= s.m) break;
      const int b = m / howo;
      const long long at = static_cast<long long>(b) * s.n * howo + (m - b * howo);
      for (int col = c0 + cw; col < c1; col += 8) {
        if (a.out_bf16) {
          static_cast<__nv_bfloat16*>(out)[at + static_cast<long long>(n0 + col) * howo] =
              st_h[col * kStageBf16 + e];
        } else {
          static_cast<float*>(out)[at + static_cast<long long>(n0 + col) * howo] =
              st_f[col * kStageF32 + e];
        }
      }
    }
  }
  if (a.splits > 1) cluster_wait();  // no block leaves while another reads its partial
}

// K6 on `stream`: two launches; partial holds absmax_blocks(n) floats.
cudaError_t launch_absmax(const void* x, long long n, int is_bf16, float* partial, float* s_x,
                          cudaStream_t stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const int blocks = absmax_blocks(n);
  const long long per = is_bf16 ? 8 : 4;
  const long long chunks = (reinterpret_cast<uintptr_t>(x) % 16 == 0) ? n / per : 0;
  if (is_bf16) {
    absmax_partial<true><<<blocks, kAbsThreads, 0, stream>>>(x, n, chunks, partial);
  } else {
    absmax_partial<false><<<blocks, kAbsThreads, 0, stream>>>(x, n, chunks, partial);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  absmax_final<<<1, kAbsThreads, 0, stream>>>(partial, blocks, s_x);
  return cudaGetLastError();
}

bool quantize_shape_ok(int b, int c, long long hw) {
  return b > 0 && b <= 65535 && c > 0 && c % 4 == 0 && hw > 0 &&
         (c + kQuantC - 1) / kQuantC <= 65535 && (hw + kQuantP - 1) / kQuantP <= INT_MAX;
}

// K7 on `stream`: one launch (the shape checked by quantize_shape_ok)
cudaError_t launch_quantize(const void* x, const float* s_x, int8_t* q, int b, int c,
                            long long hw, int is_bf16, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((hw + kQuantP - 1) / kQuantP),
                  static_cast<unsigned>((c + kQuantC - 1) / kQuantC), static_cast<unsigned>(b));
  if (is_bf16) {
    quantize_act_kernel<true><<<grid, kQuantThreads, 0, stream>>>(x, s_x, q, c, hw);
  } else {
    quantize_act_kernel<false><<<grid, kQuantThreads, 0, stream>>>(x, s_x, q, c, hw);
  }
  return cudaGetLastError();
}

// K8's shape, or false where the kernel does not take it (the pixel index of
// the codes and each of H, W as int16 in the producer's registers)
bool conv_shape(int b, int h, int w, int c, int n, int kh, int kw, int stride, int pad,
                ConvShape* s) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || c % 16 != 0 || n <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || pad < 0 || h >= 32767 || w >= 32767 ||
      static_cast<long long>(b) * h * w >= (1LL << 31) ||
      static_cast<long long>(kh) * kw * c >= (1LL << 31) || (n + 127) / 128 > 65535) {
    return false;
  }
  s->h = h;
  s->w = w;
  s->c = c;
  s->n = n;
  s->kh = kh;
  s->kw = kw;
  s->stride = stride;
  s->pad = pad;
  s->ho = (h + 2 * pad - kh) / stride + 1;
  s->wo = (w + 2 * pad - kw) / stride + 1;
  s->k = kh * kw * c;
  s->m = static_cast<long long>(b) * s->ho * s->wo;
  return s->ho > 0 && s->wo > 0 && s->m < (1LL << 31);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The weight codes' tensor map: [N, K] int8 in boxes of BN rows x 128
// bytes, 128-byte swizzle, zeros outside. A map holds only the pointer and
// the shape, so it is cached on those (a small ring, under a lock: ctypes
// calls come without the GIL).
bool weight_map(const int8_t* wq, int n, int k, int bn, CUtensorMap* map) {
  struct Entry {
    const int8_t* wq;
    int n, k, bn;
    CUtensorMap map;
  };
  static Entry cache[64];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.wq == wq && e.n == n && e.k == k && e.bn == bn) {
      *map = e.map;
      return true;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(bn)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(wq),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return false;
  cache[next] = Entry{wq, n, k, bn, *map};
  next = (next + 1) % 64;
  if (used < 64) ++used;
  return true;
}

template <int BN>
cudaError_t launch_conv_bn(const CUtensorMap& map, const int8_t* xq, const float* s_x,
                           const float* s_w, const void* bias, void* out, const ConvArgs& a,
                           int n_tiles, cudaStream_t stream) {
  constexpr int kSmem = conv_smem_bytes<BN>();
  static bool ready[64] = {};  // per device: the shared-memory limit raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(int8_conv_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.m_tiles), static_cast<unsigned>(n_tiles),
                     static_cast<unsigned>(a.splits));
  cfg.blockDim = dim3(kConvThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = static_cast<unsigned>(a.splits);  // a tile's splits
  cfg.attrs = cluster;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, int8_conv_wgmma<BN>, map, xq, s_x, s_w, bias, out, a);
}

// K8 on `stream`: one launch; xq and wq 16-byte aligned
cudaError_t launch_conv(const int8_t* xq, const int8_t* wq, const float* s_x, const float* s_w,
                        const void* bias, void* out, int out_bf16, const ConvShape& s,
                        cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(xq) % 16 != 0 || reinterpret_cast<uintptr_t>(wq) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const ConvPlan p = plan_conv(s.m, s.n, s.k);
  if (p.splits > 1 && (p.bn != 128 || p.splits > kMaxSplits)) {  // a split's partial and
    return cudaErrorInvalidValue;                                 // staging share the ring
  }
  CUtensorMap map;
  if (!weight_map(wq, s.n, s.k, p.bn, &map)) return cudaErrorInvalidValue;
  ConvArgs a;
  a.s = s;
  a.m_tiles = p.m_tiles;
  a.steps = p.steps;
  a.steps_per_split = p.steps_per_split;
  a.splits = p.splits;
  a.out_bf16 = out_bf16;
  a.vec_store = static_cast<long long>(s.ho) * s.wo % (out_bf16 ? 8 : 4) == 0 &&
                reinterpret_cast<uintptr_t>(out) % 16 == 0;
  switch (p.bn) {
    case 128:
      return launch_conv_bn<128>(map, xq, s_x, s_w, bias, out, a, p.n_tiles, stream);
    case 192:
      return launch_conv_bn<192>(map, xq, s_x, s_w, bias, out, a, p.n_tiles, stream);
    case 240:
      return launch_conv_bn<240>(map, xq, s_x, s_w, bias, out, a, p.n_tiles, stream);
    default:
      return launch_conv_bn<256>(map, xq, s_x, s_w, bias, out, a, p.n_tiles, stream);
  }
}

long long align16(long long n) { return (n + 15) / 16 * 16; }

}  // namespace

// The float32 words of scratch that fovealseg_absmax_scale needs for n elements.
extern "C" int fovealseg_absmax_partials(long long n) { return absmax_blocks(n); }

// K6. x: n contiguous f32 (is_bf16 = 0) or bf16 (1) values, 0 < n;
// partial: fovealseg_absmax_partials(n) f32 words of scratch; s_x: one f32.
// Two launches on `stream`; returns the CUDA error of the launches.
extern "C" int fovealseg_absmax_scale(const void* x, long long n, int is_bf16, void* partial,
                                      void* s_x, void* stream_handle) {
  return static_cast<int>(launch_absmax(x, n, is_bf16, static_cast<float*>(partial),
                                        static_cast<float*>(s_x),
                                        static_cast<cudaStream_t>(stream_handle)));
}

// K7. x [b, c, hw] contiguous f32 or bf16, s_x one f32 on the card, q [b, hw, c]
// int8; 0 < b < 65536, 0 < c, c % 4 == 0, 0 < hw, q 4-byte aligned (checked
// by the Python wrapper).
extern "C" int fovealseg_quantize_act(const void* x, const void* s_x, void* q, int b, int c,
                                      long long hw, int is_bf16, void* stream_handle) {
  if (!quantize_shape_ok(b, c, hw)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_quantize(x, static_cast<const float*>(s_x),
                                          static_cast<int8_t*>(q), b, c, hw, is_bf16,
                                          static_cast<cudaStream_t>(stream_handle)));
}

// The planner's choice for an M x N x K conv (K = kh * kw * C), as six ints:
// BN, M tiles, N tiles, K steps of 128 bytes, splits, steps per split.
extern "C" void fovealseg_int8_conv_plan(long long m, int n, int k, int* plan) {
  const ConvPlan p = plan_conv(m, n, k);
  const int v[6] = {p.bn, p.m_tiles, p.n_tiles, p.steps, p.splits, p.steps_per_split};
  for (int i = 0; i < 6; ++i) plan[i] = v[i];
}

// K8. xq [b, h, w, c] int8 (K7's codes), wq [n, kh, kw, c] int8, s_x one f32,
// s_w [n] f32, bias [n] in the output dtype or null, out [b, n, ho, wo] f32
// (out_bf16 = 0) or bf16 (1). c % 16 == 0, xq and wq 16-byte aligned,
// b * ho * wo < 2^31 (checked by the Python wrapper, and the shapes here).
extern "C" int fovealseg_int8_conv2d(const void* xq, const void* wq, const void* s_x,
                                     const void* s_w, const void* bias, void* out, int b, int h,
                                     int w, int c, int n, int kh, int kw, int stride, int pad,
                                     int out_bf16, void* stream_handle) {
  ConvShape s;
  if (!conv_shape(b, h, w, c, n, kh, kw, stride, pad, &s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_conv(static_cast<const int8_t*>(xq),
                                      static_cast<const int8_t*>(wq),
                                      static_cast<const float*>(s_x),
                                      static_cast<const float*>(s_w), bias, out, out_bf16, s,
                                      static_cast<cudaStream_t>(stream_handle)));
}

// The bytes of scratch that fovealseg_w8a8_conv2d needs for n activation
// elements: the codes (n, rounded up to 16), K6's partials, s_x.
extern "C" long long fovealseg_w8a8_workspace_bytes(long long n) {
  return align16(n) + 4LL * kAbsMaxBlocks + 16;
}

// The W8A8 conv of one activation, the path's one call per quantized conv:
// K6, K7 and K8 in turn on `stream` (four launches), nothing in between on
// the host. x [b, c, h, w] contiguous f32 (is_bf16 = 0) or bf16 (1), wq
// [n, k, k, c] int8 (16-byte aligned), s_w [n] f32, bias [n] in x's dtype or
// null, workspace fovealseg_w8a8_workspace_bytes(b * c * h * w) bytes
// (16-byte aligned), out [b, n, ho, wo] in x's dtype. Every shape is checked
// before the first launch.
extern "C" int fovealseg_w8a8_conv2d(const void* x, int is_bf16, const void* wq, const void* s_w,
                                     const void* bias, void* workspace, void* out, int b, int h,
                                     int w, int c, int n, int k, int stride, int pad,
                                     void* stream_handle) {
  ConvShape s;
  const long long hw = static_cast<long long>(h) * w;
  if (!conv_shape(b, h, w, c, n, k, k, stride, pad, &s) || !quantize_shape_ok(b, c, hw) ||
      reinterpret_cast<uintptr_t>(workspace) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const long long elems = static_cast<long long>(b) * c * hw;
  auto* codes = static_cast<int8_t*>(workspace);
  auto* partial = reinterpret_cast<float*>(codes + align16(elems));
  float* s_x = partial + kAbsMaxBlocks;
  cudaError_t err = launch_absmax(x, elems, is_bf16, partial, s_x, stream);
  if (err == cudaSuccess) err = launch_quantize(x, s_x, codes, b, c, hw, is_bf16, stream);
  if (err == cudaSuccess) {
    err = launch_conv(codes, static_cast<const int8_t*>(wq), s_x, static_cast<const float*>(s_w),
                      bias, out, is_bf16, s, stream);
  }
  return static_cast<int>(err);
}
