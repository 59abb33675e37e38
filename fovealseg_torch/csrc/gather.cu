// Row gather for Hopper (sm_90a): out[b, p, :] = table[b, idx[b, p], :],
// and its backward, a scatter-add of the gradient rows.
//
// Replaces: fovealseg_tpu/ops/pallas_gather.py::windowed_row_gather (body
// _kernel_impl), the full-res score-map gather of the inverse warp, and the
// XLA flat gather it falls back to (core/unwarp.py::_gather_rows_flat). The
// TPU kernel's per-tile index windows, its channel-major table blocks and
// its coverage fallback work around Mosaic's lack of a vector gather; a GPU
// thread loads any address, so none of that carries over. This is a direct
// gather of 32-bit words: one kernel serves float32 and int32 rows and is
// bit-exact by construction (a word is copied, never computed). Indices are
// clamped to [0, T) as a gather's out-of-range indices are.
//
// What bounds it: bytes. Each index is read once and each output word
// written once; the table (10.4 MB for the b8 score map, 25-39 MB for the
// canvas tables) stays in the 50 MB L2, so its bytes are read from device
// memory about once. At b8, 640x640 canvas: C = 51, 692 MB, 0.207 ms at
// 3.35 TB/s; C = 1, 26 MB; C = 2, 66 MB; C = 3, 92 MB (bounds 8-27 us, near
// the cost of a launch).
//
// Design, one launch of one of three variants (chosen once, by
// ops/gather.py::gather_variant, and checked here by choose_variant):
//   * every variant runs a 2-D grid (blocks per image, B), so no pixel
//     divides by the image size; per-image table offsets (row * C) are 32-bit
//     where T * C < 2^31 and 64-bit otherwise (template Off), the image bases
//     64-bit once per block;
//   * kSmall, C <= 4 (the label, grid and image round trips): no shared
//     memory and no barrier. Each thread takes 4 consecutive pixels: one
//     16-byte load of their indices, one C-word vector load per row where
//     the row is a vector (8 bytes at C = 2, 16 at C = 4), and its 4*C output
//     words as C 16-byte stores. Needs N % 4 == 0, 16-byte aligned indices
//     and output, and a table aligned to its row vector;
//   * kWide, C > 4 (the score map): a block owns 128 pixels, i.e. a span of
//     128*C consecutive output words, stages their row offsets in shared
//     memory, and writes the span as 16-byte chunks (a chunk may straddle two
//     pixels). Each thread computes the places of 4 chunks by stepping, then
//     has their 16 table loads in flight before the 4 stores, which stream
//     past L2 (st.global.cs) so that the table and the index map stay there.
//     Needs N * C % 4 == 0 and a 16-byte aligned output. The span and the
//     unroll were picked by timing the score map on the card: a span of 128
//     pixels beat 256 and 512 (at 256 and 512 threads), and 4 chunks in
//     flight beat 2;
//   * kScalar, anything else (a ragged N, a view at an odd storage offset):
//     the same gather word by word, each block's row offsets staged in shared
//     memory. Never a fallback to the plain version.
//
// Backward (K5b): grad_table[b, idx[b, p], :] += grad_out[b, p, :], the
// scatter-add that JAX's autodiff makes of the flat gather
// (core/unwarp.py::_gather_rows_flat under MODEL.loss_at_high_res), into a
// table the wrapper zeroed. What bounds it: bytes (grad_out and the indices
// read once, the table written once: 9.2 MB of table and 0.7 GB of grad_out
// at b8, C = 51, 640x640 over 80x80) and, where many pixels share a row,
// the serialised atomics on one address (~64 canvas pixels per task cell on
// average, more at the periphery). Design: the kScalar gather's layout in
// reverse, one f32 atomicAdd per word. A block owns 256 pixels, stages
// their clamped row offsets in shared memory and walks its span of
// grad_out words in order, so a warp reads 32 consecutive words and, at
// C = 51, adds into consecutive words of one or two rows. The atomics sum
// in an order that changes from run to run, so the result is not
// bit-reproducible; a deterministic design (sort by row, then sum each row
// in pixel order) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The variants: the same numbers as ops/gather.py's VARIANT_*.
constexpr int kScalar = 0;
constexpr int kSmall = 1;
constexpr int kWide = 2;
constexpr int kSmallMaxC = 4;

constexpr int kThreads = 256;
constexpr int kScalarPix = 256;  // pixels per block, kScalar
constexpr int kWidePix = 128;    // pixels per block, kWide (a multiple of 4)
constexpr int kWideUnroll = 4;   // 16-byte chunks per thread in flight, kWide

int choose_variant(int c, long long n, uintptr_t table, uintptr_t idx, uintptr_t out) {
  if (c <= kSmallMaxC) {
    const uintptr_t row_align = (c == 2 || c == 4) ? 4u * c : 4u;
    if (n % 4 == 0 && idx % 16 == 0 && out % 16 == 0 && table % row_align == 0) return kSmall;
  } else if (n * c % 4 == 0 && out % 16 == 0) {
    return kWide;
  }
  return kScalar;
}

__device__ __forceinline__ int clamp_row(int32_t r, int t) {
  return r < 0 ? 0 : (r >= t ? t - 1 : r);
}

template <typename Off>
__global__ void __launch_bounds__(kThreads)
    gather_scalar(const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
                  uint32_t* __restrict__ out, int n, int t, int c) {
  __shared__ Off row_off[kScalarPix];
  const int64_t b = blockIdx.y;
  const int p0 = blockIdx.x * kScalarPix;
  const int np = min(kScalarPix, n - p0);
  const int32_t* idx_b = idx + b * n + p0;
  const uint32_t* table_b = table + b * t * c;
  uint32_t* dst = out + (b * n + p0) * c;
  for (int i = threadIdx.x; i < np; i += kThreads) {
    row_off[i] = static_cast<Off>(clamp_row(idx_b[i], t)) * c;
  }
  __syncthreads();
  const int words = np * c;  // <= 256 * 65535
  const int step_p = kThreads / c;
  const int step_c = kThreads % c;
  int pix = threadIdx.x / c;
  int ch = threadIdx.x % c;
  for (int wi = threadIdx.x; wi < words; wi += kThreads) {
    dst[wi] = table_b[row_off[pix] + ch];
    pix += step_p;
    ch += step_c;
    if (ch >= c) {
      ch -= c;
      ++pix;
    }
  }
}

template <int C, typename Off>
__global__ void __launch_bounds__(kThreads)
    gather_small(const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
                 uint32_t* __restrict__ out, int n, int t) {
  const int g = blockIdx.x * kThreads + threadIdx.x;  // pixels 4g .. 4g+3 of image b
  if (g >= n / 4) return;
  const int64_t b = blockIdx.y;
  const int4 iv = __ldcs(reinterpret_cast<const int4*>(idx + b * n) + g);
  const int rows[4] = {clamp_row(iv.x, t), clamp_row(iv.y, t), clamp_row(iv.z, t),
                       clamp_row(iv.w, t)};
  const uint32_t* table_b = table + b * t * C;
  uint32_t v[4 * C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t* row = table_b + static_cast<Off>(rows[i]) * C;
    if constexpr (C == 2) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(row));
      v[2 * i] = q.x;
      v[2 * i + 1] = q.y;
    } else if constexpr (C == 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(row));
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < C; ++j) v[C * i + j] = __ldg(row + j);
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(out + (b * n + 4 * static_cast<int64_t>(g)) * C);
#pragma unroll
  for (int j = 0; j < C; ++j) {
    dst[j] = make_uint4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  }
}

template <typename Off>
__global__ void __launch_bounds__(kThreads)
    gather_wide(const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
                uint32_t* __restrict__ out, int n, int t, int c) {
  __shared__ Off row_off[kWidePix + 1];
  const int64_t b = blockIdx.y;
  const int p0 = blockIdx.x * kWidePix;
  const int np = min(kWidePix, n - p0);
  const int32_t* idx_b = idx + b * n + p0;
  const uint32_t* table_b = table + b * t * c;
  for (int i = threadIdx.x; i < np; i += kThreads) {
    row_off[i] = static_cast<Off>(clamp_row(__ldcs(idx_b + i), t)) * c;
  }
  if (threadIdx.x == 0) row_off[np] = 0;  // read, never used, past a span's last pixel
  __syncthreads();
  // The span is np * c words, a whole number of chunks: kWidePix % 4 == 0
  // and, in this variant, n * c % 4 == 0.
  uint4* dst = reinterpret_cast<uint4*>(out + (b * n + p0) * c);
  const int chunks = np * c / 4;
  const int step_p = 4 * kThreads / c;
  const int step_c = 4 * kThreads % c;
  int pix = 4 * threadIdx.x / c;  // the first word of this thread's chunk
  int ch = 4 * threadIdx.x % c;
  for (int k0 = threadIdx.x; k0 < chunks; k0 += kThreads * kWideUnroll) {
    uint32_t v[kWideUnroll][4];
#pragma unroll
    for (int u = 0; u < kWideUnroll; ++u) {
      if (k0 + u * kThreads < chunks) {
        const Off r0 = row_off[pix];
        const Off r1 = row_off[pix + 1];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cj = ch + j;  // c > 4: a chunk reaches at most one pixel further
          v[u][j] = __ldg(table_b + (cj < c ? r0 + cj : r1 + (cj - c)));
        }
      }
      pix += step_p;
      ch += step_c;
      if (ch >= c) {
        ch -= c;
        ++pix;
      }
    }
#pragma unroll
    for (int u = 0; u < kWideUnroll; ++u) {
      if (k0 + u * kThreads < chunks) {
        __stcs(dst + k0 + u * kThreads, make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]));
      }
    }
  }
}

template <typename Off>
__global__ void __launch_bounds__(kThreads)
    scatter_add_rows(const float* __restrict__ grad_out, const int32_t* __restrict__ idx,
                     float* __restrict__ grad_table, int n, int t, int c) {
  __shared__ Off row_off[kScalarPix];
  const int64_t b = blockIdx.y;
  const int p0 = blockIdx.x * kScalarPix;
  const int np = min(kScalarPix, n - p0);
  const int32_t* idx_b = idx + b * n + p0;
  float* table_b = grad_table + b * t * c;
  const float* src = grad_out + (b * n + p0) * c;
  for (int i = threadIdx.x; i < np; i += kThreads) {
    row_off[i] = static_cast<Off>(clamp_row(__ldcs(idx_b + i), t)) * c;
  }
  __syncthreads();
  const int words = np * c;
  const int step_p = kThreads / c;
  const int step_c = kThreads % c;
  int pix = threadIdx.x / c;
  int ch = threadIdx.x % c;
  for (int wi = threadIdx.x; wi < words; wi += kThreads) {
    atomicAdd(table_b + row_off[pix] + ch, __ldcs(src + wi));
    pix += step_p;
    ch += step_c;
    if (ch >= c) {
      ch -= c;
      ++pix;
    }
  }
}

template <typename Off>
void launch(int variant, const uint32_t* table, const int32_t* idx, uint32_t* out, int b, int n,
            int t, int c, cudaStream_t stream) {
  if (variant == kSmall) {
    const dim3 grid((n / 4 + kThreads - 1) / kThreads, b);
    switch (c) {
      case 1: gather_small<1, Off><<<grid, kThreads, 0, stream>>>(table, idx, out, n, t); break;
      case 2: gather_small<2, Off><<<grid, kThreads, 0, stream>>>(table, idx, out, n, t); break;
      case 3: gather_small<3, Off><<<grid, kThreads, 0, stream>>>(table, idx, out, n, t); break;
      default: gather_small<4, Off><<<grid, kThreads, 0, stream>>>(table, idx, out, n, t); break;
    }
  } else if (variant == kWide) {
    const dim3 grid((n + kWidePix - 1) / kWidePix, b);
    gather_wide<Off><<<grid, kThreads, 0, stream>>>(table, idx, out, n, t, c);
  } else {
    const dim3 grid((n + kScalarPix - 1) / kScalarPix, b);
    gather_scalar<Off><<<grid, kThreads, 0, stream>>>(table, idx, out, n, t, c);
  }
}

}  // namespace

// table [b, t, c] 32-bit words, idx [b, n] int32, out [b, n, c] 32-bit words;
// all contiguous, 0 < b < 65536, 0 < n < 2^31, 0 < t, 0 < c <= 65535 (checked
// by the Python wrapper). `variant` is ops/gather.py's choice: it must be
// kScalar or what choose_variant picks, else nothing is launched and
// cudaErrorInvalidValue is returned. Returns the launch's CUDA error.
extern "C" int fovealseg_row_gather(const void* table, const void* idx, void* out, int b,
                                    long long n, int t, int c, int variant,
                                    void* stream_handle) {
  if (b <= 0 || n <= 0 || n >= (1LL << 31) || t <= 0 || c <= 0 || c > 65535 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chosen = choose_variant(c, n, reinterpret_cast<uintptr_t>(table),
                                    reinterpret_cast<uintptr_t>(idx),
                                    reinterpret_cast<uintptr_t>(out));
  if (variant != kScalar && variant != chosen) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const auto* tab = static_cast<const uint32_t*>(table);
  const auto* ind = static_cast<const int32_t*>(idx);
  auto* dst = static_cast<uint32_t*>(out);
  const int nn = static_cast<int>(n);
  if (static_cast<long long>(t) * c < (1LL << 31)) {
    launch<int32_t>(variant, tab, ind, dst, b, nn, t, c, stream);
  } else {
    launch<int64_t>(variant, tab, ind, dst, b, nn, t, c, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// grad_out [b, n, c] float32, idx [b, n] int32, grad_table [b, t, c] float32
// zeroed by the caller; all contiguous, with the forward's limits (checked by
// the Python wrapper). Returns the launch's CUDA error.
extern "C" int fovealseg_row_gather_backward(const void* grad_out, const void* idx,
                                             void* grad_table, int b, long long n, int t,
                                             int c, void* stream_handle) {
  if (b <= 0 || n <= 0 || n >= (1LL << 31) || t <= 0 || c <= 0 || c > 65535 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const auto* src = static_cast<const float*>(grad_out);
  const auto* ind = static_cast<const int32_t*>(idx);
  auto* dst = static_cast<float*>(grad_table);
  const int nn = static_cast<int>(n);
  const dim3 grid((nn + kScalarPix - 1) / kScalarPix, b);
  if (static_cast<long long>(t) * c < (1LL << 31)) {
    scatter_add_rows<int32_t><<<grid, kThreads, 0, stream>>>(src, ind, dst, nn, t, c);
  } else {
    scatter_add_rows<int64_t><<<grid, kThreads, 0, stream>>>(src, ind, dst, nn, t, c);
  }
  return static_cast<int>(cudaGetLastError());
}
