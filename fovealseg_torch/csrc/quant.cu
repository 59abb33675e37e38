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
// task): K6 and K7 are bytes (one read of the activation; K7 also writes a
// quarter (f32) or half (bf16) of it as codes). K8 is operations at C1's
// 3x3 960 -> 240 conv at 80x80 (212 GOP, 0.107 ms at 1,979 TOPS against
// 55 MB, 0.016 ms at 3.35 TB/s) and at HRNet's 3x3 convs of 128, 256 and 512
// channels (3.8 GOP each, ~2 us), whose time is mostly launch and tail.
//
// Design, simple and right first:
//   * K6: two launches from one entry point. Each block of the first takes a
//     grid-stride range (16-byte loads where the base is aligned), reduces
//     |x| in f32 (exact: max is order-free) and writes one partial; one
//     block of the second reduces the partials and writes s_x. No atomics,
//     no host synchronisation, the partials' scratch from the caller;
//   * K7: a 32-channel x 64-pixel tile per block, read along the pixels,
//     quantized once, staged as codes in shared memory and written along the
//     channels as 32-bit words;
//   * K8: one 128 (M = B*Ho*Wo) x 64 (N) output tile per block of 4 warps
//     (2 x 2, a 64 x 32 warp tile of 4 x 4 mma.sync.m16n8k32 s8 tiles, int32
//     accumulators in registers); K (kh*kw*C) in steps of 64 bytes, each
//     step's A (the implicit im2col rows: 16 channels of one tap per 16-byte
//     cp.async, zero-filled off the image, past M and past K) and B tiles
//     double-buffered in shared memory with rows padded to 80 bytes, so that
//     the fragments' 32-bit loads hit 32 distinct banks. The epilogue above
//     runs on the accumulators and stores NCHW directly. wgmma, TMA and
//     fusing K7 into K8's loads are later work.
//
// Entry points: fovealseg_w8a8_conv2d, what serving calls, launches K6, K7
// and K8 in turn from one host call, the codes, partials and s_x in one
// workspace of the caller's; each kernel also has an entry point of its own,
// which tests and measurements call to hold it against its plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

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

constexpr int kBM = 128, kBN = 64, kBK = 64;
constexpr int kLds = kBK + 16;  // shared row stride in bytes: 20 words, conflict-free fragments
constexpr int kConvThreads = 128;

struct ConvShape {
  int h, w, c, n, kh, kw, stride, pad, ho, wo, k;
  long long m;  // b * ho * wo
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename OutT>
struct Epilogue;

template <>
struct Epilogue<float> {
  __device__ __forceinline__ static float apply(float y, const float* bias, int n) {
    return bias ? __fadd_rn(y, bias[n]) : y;
  }
};

template <>
struct Epilogue<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 apply(float y, const __nv_bfloat16* bias,
                                                         int n) {
    const __nv_bfloat16 r = __float2bfloat16_rn(y);
    if (!bias) return r;
    return __float2bfloat16_rn(__fadd_rn(__bfloat162float(r), __bfloat162float(bias[n])));
  }
};

template <typename OutT>
__global__ void __launch_bounds__(kConvThreads)
int8_conv_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                 const float* __restrict__ s_x, const float* __restrict__ s_w,
                 const OutT* __restrict__ bias, OutT* __restrict__ out, const ConvShape s) {
  __shared__ __align__(16) int8_t a_tile[2][kBM * kLds];
  __shared__ __align__(16) int8_t b_tile[2][kBN * kLds];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const long long howo = static_cast<long long>(s.ho) * s.wo;

  // this thread's loads: A rows (tid >> 2) + 32 i, B rows (tid >> 2) + 32 i,
  // always the 16-byte unit (tid & 3) of a 64-byte K step
  const int unit = tid & 3;
  const int8_t* a_img[4];
  int a_iy[4], a_ix[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + (tid >> 2) + 32 * i;
    if (m < s.m) {
      const long long b = m / howo;
      const int p = static_cast<int>(m - b * howo);
      const int oy = p / s.wo, ox = p - (p / s.wo) * s.wo;
      a_img[i] = xq + b * s.h * static_cast<long long>(s.w) * s.c;
      a_iy[i] = oy * s.stride - s.pad;
      a_ix[i] = ox * s.stride - s.pad;
    } else {
      a_img[i] = xq;
      a_iy[i] = INT_MIN / 2;  // never on the image
      a_ix[i] = 0;
    }
  }

  auto load = [&](int kt, int buf) {
    const int k = kt * kBK + unit * 16;
    const bool k_ok = k < s.k;
    const int tap = k_ok ? k / s.c : 0;
    const int ch = k - tap * s.c;
    const int ky = tap / s.kw, kx = tap - (tap / s.kw) * s.kw;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (tid >> 2) + 32 * i;
      const int iy = a_iy[i] + ky, ix = a_ix[i] + kx;
      const bool ok = k_ok && iy >= 0 && iy < s.h && ix >= 0 && ix < s.w;
      const int8_t* src = ok ? a_img[i] + (static_cast<long long>(iy) * s.w + ix) * s.c + ch : xq;
      cp_async16(&a_tile[buf][row * kLds + unit * 16], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + 32 * i;
      const bool ok = k_ok && n0 + row < s.n;
      const int8_t* src = ok ? wq + static_cast<long long>(n0 + row) * s.k + k : wq;
      cp_async16(&b_tile[buf][row * kLds + unit * 16], src, ok);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  const int steps = (s.k + kBK - 1) / kBK;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < steps; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < steps) load(kt + 1, buf ^ 1);
    cp_async_commit();  // an empty group on the last step keeps the count
    cp_async_wait_one();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = &a_tile[buf][(wm * 64 + mi * 16 + g) * kLds + kk + 4 * t];
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLds);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLds + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = &b_tile[buf][(wn * 32 + ni * 8 + g) * kLds + kk + 4 * t];
        b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // epilogue: accumulator j of tile (mi, ni) is row g (+8 for j >= 2), column 2t + (j & 1)
  const float sx = *s_x;
  float scale[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int n = n0 + wn * 32 + ni * 8 + 2 * t + jj;
      scale[ni][jj] = n < s.n ? __fmul_rn(sx, s_w[n]) : 0.f;
    }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * 64 + mi * 16 + g + 8 * half;
      if (m >= s.m) continue;
      const long long b = m / howo;
      OutT* o = out + b * s.n * howo + (m - b * howo);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int n = n0 + wn * 32 + ni * 8 + 2 * t + jj;
          if (n >= s.n) continue;
          const float y = __fmul_rn(__int2float_rn(acc[mi][ni][2 * half + jj]), scale[ni][jj]);
          o[static_cast<long long>(n) * howo] = Epilogue<OutT>::apply(y, bias, n);
        }
    }
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

// K8's shape, or false where the kernel does not take it
bool conv_shape(int b, int h, int w, int c, int n, int kh, int kw, int stride, int pad,
                ConvShape* s) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || c % 16 != 0 || n <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || pad < 0 || static_cast<long long>(kh) * kw * c >= (1LL << 31) ||
      (n + kBN - 1) / kBN > 65535) {
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

// K8 on `stream`: one launch; xq and wq 16-byte aligned
cudaError_t launch_conv(const int8_t* xq, const int8_t* wq, const float* s_x, const float* s_w,
                        const void* bias, void* out, int out_bf16, const ConvShape& s,
                        cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(xq) % 16 != 0 || reinterpret_cast<uintptr_t>(wq) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(static_cast<unsigned>((s.m + kBM - 1) / kBM),
                  static_cast<unsigned>((s.n + kBN - 1) / kBN));
  if (out_bf16) {
    int8_conv_kernel<__nv_bfloat16><<<grid, kConvThreads, 0, stream>>>(
        xq, wq, s_x, s_w, static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(out), s);
  } else {
    int8_conv_kernel<float><<<grid, kConvThreads, 0, stream>>>(
        xq, wq, s_x, s_w, static_cast<const float*>(bias), static_cast<float*>(out), s);
  }
  return cudaGetLastError();
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
