// Row gather for Hopper (sm_90a): out[b, p, :] = table[b, idx[b, p], :].
//
// Replaces: fovealseg_tpu/ops/pallas_gather.py::windowed_row_gather (body
// _kernel_impl), the full-res score-map gather of the inverse warp, and the
// XLA flat gather it falls back to (core/unwarp.py::_gather_rows_flat). The
// TPU kernel's per-tile index windows, its channel-major table blocks and
// its coverage fallback work around Mosaic's lack of a vector gather; a GPU
// thread loads any address, so none of that carries over. This is a direct
// gather of 32-bit words: one kernel serves float32 and int32 rows and is
// bit-exact by construction (a word is copied, never computed).
//
// What bounds it: bytes written. At b8, 640x640 canvas, 51 channels the
// output is 668.5 MB, beside 13.1 MB of indices and a 10.4 MB table: 692 MB,
// 0.207 ms at 3.35 TB/s. The design keeps the writes at full rate:
//   * one block owns kPix consecutive pixels, i.e. kPix*C consecutive output
//     words, and its threads walk them with neighbouring threads on
//     neighbouring words, so every store is coalesced and each output byte
//     is written once;
//   * the block first reads its kPix indices once (coalesced) into shared
//     memory as 64-bit table-row offsets, so the word loop does no division
//     by C: each thread steps its (pixel, channel) pair by the fixed
//     (blockDim / C, blockDim % C);
//   * table reads are served from L2, which holds the whole 10.4 MB table,
//     and rows of neighbouring pixels mostly coincide (the warp is smooth).
// Indices are clamped to [0, T) as a gather's out-of-range indices are; the
// callers never produce one.
//
// Later work: 16-byte vector stores where C allows, and fusing this gather
// into the jump flood's final pass, which would save writing and re-reading
// the index map.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPix = 256;
constexpr int kThreads = 256;

__global__ void row_gather(const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
                           uint32_t* __restrict__ out, int64_t total, int64_t n, int t, int c) {
  __shared__ int64_t row_off[kPix];
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPix;  // flat pixel over [b, n]
  const int np = total - p0 < kPix ? static_cast<int>(total - p0) : kPix;
  for (int i = threadIdx.x; i < np; i += kThreads) {
    const int64_t p = p0 + i;
    const int64_t b = p / n;
    const int32_t i_raw = idx[p];
    const int32_t row = i_raw < 0 ? 0 : (i_raw >= t ? t - 1 : i_raw);
    row_off[i] = (b * t + row) * c;
  }
  __syncthreads();
  uint32_t* dst = out + p0 * c;
  const int words = np * c;
  const int step_p = kThreads / c;
  const int step_c = kThreads % c;
  int pix = threadIdx.x / c;
  int ch = threadIdx.x % c;
  for (int wi = threadIdx.x; wi < words; wi += kThreads) {
    dst[wi] = table[row_off[pix] + ch];
    pix += step_p;
    ch += step_c;
    if (ch >= c) {
      ch -= c;
      ++pix;
    }
  }
}

}  // namespace

// table [b, t, c] 32-bit words, idx [b, n] int32, out [b, n, c] 32-bit words;
// all contiguous, 0 < c <= 65535 and b*n < 2^31 * 256 (checked by the Python wrapper).
extern "C" int fovealseg_row_gather(const void* table, const void* idx, void* out, int b,
                                    long long n, int t, int c, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int64_t total = static_cast<int64_t>(b) * n;
  const int64_t blocks = (total + kPix - 1) / kPix;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  row_gather<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(table), static_cast<const int32_t*>(idx),
      static_cast<uint32_t*>(out), total, n, t, c);
  return static_cast<int>(cudaGetLastError());
}
