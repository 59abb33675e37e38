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
// Backward (K5b): the gradient of the gather with respect to its table, the
// scatter-add that JAX's autodiff makes of the flat gather
// (core/unwarp.py::_gather_rows_flat under MODEL.loss_at_high_res):
//
//   grad[b, r, c] = the f32 sum, in ascending pixel order p, of grad_out[b, p, c]
//                   over the p with clamp(idx[b, p], 0, T-1) == r,
//
// one dependent chain of f32 adds per (b, r, c) starting from +0.0; rows no
// pixel reaches are +0.0. That is the order in which the JAX package's CPU
// scatter sums (bit-equal to np.add.at), so K5b is bit-equal to the JAX
// gradient and to ops/gather.py::row_gather_backward_plain, and its bits
// depend on the inputs alone: no f32 atomic touches the result, and the
// launch configuration and the scheduling change nothing.
//
// What bounds it: bytes. grad_out is read once and the table written once:
// at b8, 640x640 over 80x80, C = 51, 'nearest' reads 0.67 GB and writes
// 10 MB (bound 0.207 ms at 3.35 TB/s); the 'BI' far fill (T = 640x640)
// writes 0.67 GB more, 98.5% of it zeros (bound 0.403 ms). On top come ~5
// passes over 13 MB of int32 indices and pixel ids. Design, five launches
// (six for C > 32) on the caller's stream, no host synchronisation, scratch
// from the caller (fovealseg_row_gather_backward_scratch int32 words):
//   1. k5b_zero: the per-row counts, the per-image cursors and the whole
//      table to 0, in 16-byte stores. Zeroing only the rows that no pixel
//      reaches, inside step 3, so that every word is written once, measured
//      slower in 'BI' than this plain fill, which writes the 1.5% of rows
//      that pixels reach twice;
//   2. k5b_count: each row's pixel count (integer atomics, one per run of
//      equal rows among a warp's consecutive pixels: neighbours share rows);
//   3. k5b_alloc: each non-empty row a segment of its image's pixel-id list
//      (a scan of a block's 256 rows' counts, two atomics per block) and an
//      entry {row, count, segment} in its image's list of non-empty rows;
//   4. k5b_place: each pixel id into its row's segment (one atomic per run).
//      The order within a segment is whatever the atomics gave;
//   5. k5b_reduce: one wave of blocks whose warps stride over the non-empty
//      rows, one row at a time. A warp sorts the row's pixel ids into
//      ascending order with a bitmap over a window of 8192 ids (an id sets
//      its bit; a warp scan of the words' popcounts places each id): ids are
//      unique, so this is exact, and a window holds a row of a coherent index
//      map whole (a task cell covers a few canvas lines). A row that spans
//      more takes one more window per 8192 ids of span; a row of up to 128
//      ids is sorted from registers into shared memory. Then the warp sums
//      the row's gradient rows in ascending pixel order: for C > 32 each lane
//      owns two channels and loads them for 16 pixels at a time (sum_wide);
//      for C <= 32 a lane loads one channel of one of 32 / C pixels per step,
//      8 steps at a time (sum_narrow). The adds run in pixel order in the
//      lane that owns the channel (shuffles bring it the other slots'
//      values);
//   6. k5b_reduce_long, for C > 32 only: the rows of more than 256 pixels,
//      which step 5 only sorted. Foveation makes a few peripheral task cells
//      collect up to ~2,000 canvas pixels (~2% of the rows of the flagship's
//      training step are over 256, against ~64 on average); one warp
//      walking such a row 16 pixels at a time trailed the grid. Here a block
//      takes 64 channels of a row (a row's slices run at once), loads them
//      for 128 pixels at a time into shared memory with all its threads, and
//      the channels' owners add them in order while the next 128 are in
//      flight. 512 pixels of 16 channels per stage measured slower: the
//      owners' serial adds then outlast the loads.
// Only integer atomics are used, and only for counts and places, whose
// results do not depend on their order (the segments' layout and the row
// list's order do, but no sum reads them in that order). Measured on the
// card (tools/profile_gather.py, PERF.md): the reduce takes ~0.32 ms of the
// 'nearest' call's ~0.38 ms, ~2/3 of its read bound; a sort folded into it
// beat a separate sort launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

// ---- K5b ----

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 8;       // warps per block, k5b_reduce
constexpr int kWindowWords = 256;  // bitmap words per warp: a window of 8192 pixel ids
constexpr int kWindow = 32 * kWindowWords;
constexpr int kWordsPerLane = kWindowWords / 32;
constexpr int kIdRegs = 4;         // a row of up to 32 * kIdRegs ids is sorted from registers
constexpr int kWideBatch = 16;     // pixels whose gradient loads a lane has in flight, sum_wide
constexpr int kNarrowSteps = 8;    // steps of 32 / w pixels whose loads are in flight, sum_narrow
constexpr int kLongRow = 256;      // c > 32: rows of more pixels go to k5b_reduce_long
constexpr int kLongPix = 128;      // pixels per stage, k5b_reduce_long
constexpr int kLongSlice = 64;     // channels per block, k5b_reduce_long
constexpr int kLongWords = kLongPix * kLongSlice / kThreads;         // words per thread, a stage
constexpr int kLongIds = (kLongPix + kThreads - 1) / kThreads;       // ids per thread, a stage
constexpr int kNoId = 0x7fffffff;
constexpr long long kZeroBlocks = 4096;  // k5b_zero's blocks, at most

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = min(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// A run of equal rows among a warp's 32 consecutive pixels: every lane gets
// the lane that starts its run, that lane also the run's length.
struct Run {
  int head;
  int len;
};

__device__ __forceinline__ Run warp_run(int row, int lane) {
  const int prev = __shfl_up_sync(kFull, row, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || row != prev);
  const unsigned upto = kFull >> (31 - lane);  // lanes 0..lane
  const unsigned later = heads & ~upto;
  return Run{31 - __clz(heads & upto), (later ? __ffs(later) - 1 : 32) - lane};
}

// Zeroes `words` 32-bit words at p: 16-byte stores from p's first 16-byte
// boundary, the up to 3 words before it and after the last store one by one.
__device__ __forceinline__ void zero_words(uint32_t* p, long long words, long long i,
                                           long long stride) {
  const long long to_16 = (16 - reinterpret_cast<uintptr_t>(p) % 16) % 16 / 4;
  const long long head = to_16 < words ? to_16 : words;
  const long long n4 = (words - head) / 4;
  uint4* body = reinterpret_cast<uint4*>(p + head);
  if (i < head) p[i] = 0;
  for (long long k = i; k < n4; k += stride) body[k] = make_uint4(0, 0, 0, 0);
  if (head + 4 * n4 + i < words) p[head + 4 * n4 + i] = 0;
}

// The scratch's counts and cursors, and the whole gradient table.
__global__ void __launch_bounds__(kThreads)
    k5b_zero(uint32_t* __restrict__ a, long long a_words, uint32_t* __restrict__ b,
             long long b_words) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  zero_words(a, a_words, i, stride);
  zero_words(b, b_words, i, stride);
}

// counts[b, r] = the number of pixels of image b whose clamped index is r.
__global__ void __launch_bounds__(kThreads)
    k5b_count(const int32_t* __restrict__ idx, int32_t* __restrict__ counts, int n, int t) {
  const int64_t b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int row = p < n ? clamp_row(__ldg(idx + b * n + p), t) : -1;
  const Run run = warp_run(row, lane);
  if (lane == run.head && row >= 0) atomicAdd(counts + b * t + row, run.len);
}

// Each non-empty row: a segment of its image's id list, whose first place
// goes to fill[b, r], and an entry {r, count, first place} in its image's
// list of non-empty rows. A warp takes 32 consecutive rows, a block 256.
__global__ void __launch_bounds__(kThreads)
    k5b_alloc(const int32_t* __restrict__ counts, int32_t* __restrict__ heads,
              int32_t* __restrict__ nrows, int32_t* __restrict__ fill, int4* __restrict__ rows,
              int t, int cap) {
  __shared__ int warp_pixels[kThreads / 32 + 1];  // exclusive prefixes over the warps
  __shared__ int warp_rows[kThreads / 32 + 1];
  const int64_t b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r0 = static_cast<long long>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
  const long long r = r0 + lane;
  const int count = r < t ? counts[b * t + r] : 0;
  const int incl = warp_inclusive_sum(count, lane);
  const unsigned used = __ballot_sync(kFull, count > 0);
  if (lane == 31) {
    warp_pixels[warp + 1] = incl;
    warp_rows[warp + 1] = __popc(used);
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the block's two atomics, then each warp's place in its share
    warp_pixels[0] = 0;
    warp_rows[0] = 0;
    for (int w = 1; w <= kThreads / 32; ++w) {
      warp_pixels[w] += warp_pixels[w - 1];
      warp_rows[w] += warp_rows[w - 1];
    }
    const int pixels = warp_pixels[kThreads / 32];
    const int nonempty = warp_rows[kThreads / 32];
    const int base = pixels > 0 ? atomicAdd(heads + b, pixels) : 0;
    const int slot = nonempty > 0 ? atomicAdd(nrows + b, nonempty) : 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      warp_pixels[w] += base;
      warp_rows[w] += slot;
    }
  }
  __syncthreads();
  if (count > 0) {
    const int first = warp_pixels[warp] + incl - count;
    fill[b * t + r] = first;
    rows[b * cap + warp_rows[warp] + __popc(used & ~(kFull << lane))] =
        make_int4(static_cast<int>(r), count, first, 0);
  }
}

// ids[b, fill[b, r] ...] = the pixels of row r, in the order the atomics give.
__global__ void __launch_bounds__(kThreads)
    k5b_place(const int32_t* __restrict__ idx, int32_t* __restrict__ fill,
              int32_t* __restrict__ ids, int n, int t) {
  const int64_t b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int row = p < n ? clamp_row(__ldcs(idx + b * n + p), t) : -1;
  const Run run = warp_run(row, lane);
  int at = 0;
  if (lane == run.head && row >= 0) at = atomicAdd(fill + b * t + row, run.len);
  at = __shfl_sync(kFull, at, run.head) + (lane - run.head);
  if (row >= 0) ids[b * n + at] = static_cast<int>(p);
}

// Where bitmap word w (of lane w / kWordsPerLane) is kept: rotated by the
// lane's quarter, so that the 32 lanes' k-th words lie in 32 banks.
__device__ __forceinline__ int bitmap_slot(int w) {
  const int l = w / kWordsPerLane;
  return kWordsPerLane * l + ((w + (l >> 2)) & (kWordsPerLane - 1));
}

// Marks id in the warp's bitmap if it lies in the window [lo, lo + kWindow),
// else keeps the least id past the window in next.
__device__ __forceinline__ void mark(int id, int lo, uint32_t* bm, int& next) {
  const unsigned d = static_cast<unsigned>(id - lo);
  if (d < kWindow) {
    atomicOr(bm + bitmap_slot(d >> 5), 1u << (d & 31));
  } else if (id > lo) {
    next = min(next, id);
  }
}

// One warp: the len > 1 distinct pixel ids at seg, ascending, into out. bm is
// the warp's bitmap of kWindowWords words, zero on entry and on return. Each
// window of kWindow ids starts at the least id not yet placed: its ids set
// their bits, and lane l takes words kWordsPerLane * l.. in order, so a warp
// scan of the lanes' popcounts gives each id its place. A row of up to
// 32 * kIdRegs ids is read once into registers; a longer one is read from
// seg once per window.
__device__ void sort_ids(const int32_t* seg, int len, int32_t* out, uint32_t* bm, int lane) {
  const bool in_regs = len <= 32 * kIdRegs;
  int my[kIdRegs];
  int lo = kNoId;
  if (in_regs) {
#pragma unroll
    for (int j = 0; j < kIdRegs; ++j) {
      my[j] = lane + 32 * j < len ? seg[lane + 32 * j] : kNoId;
      lo = min(lo, my[j]);
    }
  } else {
    for (int i = lane; i < len; i += 32) lo = min(lo, seg[i]);
  }
  lo = warp_min(lo);
  int done = 0;
  for (;;) {
    int next = kNoId;  // the least id past this window
    if (in_regs) {
#pragma unroll
      for (int j = 0; j < kIdRegs; ++j) {
        if (lane + 32 * j < len) mark(my[j], lo, bm, next);
      }
    } else {
      for (int i = lane; i < len; i += 32) mark(seg[i], lo, bm, next);
    }
    next = warp_min(next);
    __syncwarp();
    uint32_t words[kWordsPerLane];
    int count = 0;
#pragma unroll
    for (int k = 0; k < kWordsPerLane; ++k) {
      const int slot = bitmap_slot(kWordsPerLane * lane + k);
      words[k] = bm[slot];
      bm[slot] = 0;
      count += __popc(words[k]);
    }
    const int incl = warp_inclusive_sum(count, lane);
    int at = done + incl - count;
    const int first = lo + 32 * kWordsPerLane * lane;
#pragma unroll
    for (int k = 0; k < kWordsPerLane; ++k) {
      for (uint32_t bits = words[k]; bits; bits &= bits - 1) {
        out[at++] = first + 32 * k + __ffs(bits) - 1;
      }
    }
    done += __shfl_sync(kFull, incl, 31);
    __syncwarp();
    if (next == kNoId) break;
    lo = next;
  }
}

// One warp: channels [c0, c0 + w) (1 <= w <= 32) of the gradient rows of
// the len pixels whose ascending ids are at order, summed in that order into
// dst. lane = slot * w + channel: a step covers 32 / w pixels (lanes past the
// last whole slot load nothing), kNarrowSteps steps' loads are in flight,
// the ids of the next steps are loaded while these are summed, and the
// channel's owner (slot 0) adds the slots' values in order through shuffles.
__device__ void sum_narrow(const float* __restrict__ src, const int32_t* order, int len, int c,
                           int c0, int w, float* __restrict__ dst, int lane) {
  const int slots = 32 / w;
  const int slot = lane / w;
  const int ch = c0 + lane % w;
  const bool live = slot < slots && ch < c;
  const int per_batch = slots * kNarrowSteps;
  int next[kNarrowSteps];
#pragma unroll
  for (int u = 0; u < kNarrowSteps; ++u) {
    const int q = u * slots + slot;
    next[u] = live && q < len ? order[q] : 0;
  }
  float acc = 0.0f;
  for (int q0 = 0; q0 < len; q0 += per_batch) {
    int pid[kNarrowSteps];
#pragma unroll
    for (int u = 0; u < kNarrowSteps; ++u) {
      pid[u] = next[u];
      const int q = q0 + per_batch + u * slots + slot;
      if (q0 + per_batch < len) next[u] = live && q < len ? order[q] : 0;
    }
    float v[kNarrowSteps];
#pragma unroll
    for (int u = 0; u < kNarrowSteps; ++u) {  // the loads first
      const int q = q0 + u * slots + slot;
      v[u] = live && q < len ? __ldcs(src + static_cast<int64_t>(pid[u]) * c + ch) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kNarrowSteps; ++u) {  // then the adds, in pixel order
      if (q0 + u * slots < len) {
        for (int s = 0; s < slots; ++s) {
          const float x = __shfl_sync(kFull, v[u], s * w + lane % w);
          if (q0 + u * slots + s < len) acc = __fadd_rn(acc, x);
        }
      }
    }
  }
  if (slot == 0 && ch < c) dst[ch] = acc;
}

// One warp: all c > 32 channels of the row's gradient rows, summed in pixel
// order into dst. Each lane owns channels c0 + lane and c0 + 32 + lane, in
// passes of 64, and loads them for kWideBatch pixels before it adds; the ids
// of the next 32 pixels are loaded while these are summed.
__device__ void sum_wide(const float* __restrict__ src, const int32_t* order, int len, int c,
                         float* __restrict__ dst, int lane) {
  for (int c0 = 0; c0 < c; c0 += 64) {
    const int ch = c0 + lane;
    const bool live0 = ch < c;
    const bool live1 = ch + 32 < c;
    float acc0 = 0.0f;
    float acc1 = 0.0f;
    int pid_next = lane < len ? order[lane] : 0;
    for (int j0 = 0; j0 < len; j0 += 32) {
      const int m = min(32, len - j0);
      const int pid = pid_next;
      if (j0 + 32 < len) pid_next = j0 + 32 + lane < len ? order[j0 + 32 + lane] : 0;
      for (int s0 = 0; s0 < m; s0 += kWideBatch) {
        float v0[kWideBatch];
        float v1[kWideBatch];
#pragma unroll
        for (int u = 0; u < kWideBatch; ++u) {  // the loads first
          if (s0 + u < m) {
            const float* row = src + static_cast<int64_t>(__shfl_sync(kFull, pid, s0 + u)) * c + ch;
            v0[u] = live0 ? __ldcs(row) : 0.0f;
            v1[u] = live1 ? __ldcs(row + 32) : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kWideBatch; ++u) {  // then the adds, in pixel order
          if (s0 + u < m) {
            acc0 = __fadd_rn(acc0, v0[u]);
            acc1 = __fadd_rn(acc1, v1[u]);
          }
        }
      }
    }
    if (live0) dst[ch] = acc0;
    if (live1) dst[ch + 32] = acc1;
  }
}

// One warp per non-empty row: its pixel ids sorted (sort_ids; a row of up
// to 128 ids into the warp's shared `list`, a longer one into `sorted`),
// then its gradient rows summed in ascending pixel order: sum_narrow for c
// <= 32, sum_wide for c > 32. A kWide row of more than kLongRow pixels is
// only sorted here and put on its image's list of long rows, for
// k5b_reduce_long. ids and sorted are not __restrict__, and their loads
// are plain ones: a warp reads back what it has just written (ordered by
// __syncwarp).
template <bool kWide>
__global__ void __launch_bounds__(kRowWarps * 32, kWide ? 4 : 6)
    k5b_reduce(const float* __restrict__ grad_out, const int32_t* __restrict__ nrows,
               const int4* __restrict__ rows, int32_t* __restrict__ nlong,
               int4* __restrict__ long_rows, const int32_t* ids, int32_t* sorted,
               float* __restrict__ grad, int n, int t, int c, int cap) {
  const int64_t b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  __shared__ uint32_t bitmap[kRowWarps][kWindowWords];
  __shared__ int32_t short_rows[kRowWarps][32 * kIdRegs];  // a sorted row of <= 128 ids
  uint32_t* bm = bitmap[threadIdx.x >> 5];
  int32_t* list = short_rows[threadIdx.x >> 5];
  for (int i = lane; i < kWindowWords; i += 32) bm[i] = 0;
  const float* src = grad_out + b * n * c;
  const int used = nrows[b];
  for (int k = blockIdx.x * kRowWarps + (threadIdx.x >> 5); k < used;
       k += gridDim.x * kRowWarps) {
    const int4 e = rows[b * cap + k];  // {row, count, first place}
    const int len = e.y;
    const int32_t* order = ids + b * n + e.z;
    __syncwarp();  // the previous row's reads of `list` are done
    if (len > 1) {
      int32_t* out = len <= 32 * kIdRegs ? list : sorted + b * n + e.z;
      sort_ids(order, len, out, bm, lane);
      order = out;
    }
    __syncwarp();
    float* dst = grad + (b * t + e.x) * c;
    if (!kWide) {
      sum_narrow(src, order, len, c, 0, c, dst, lane);
    } else if (len <= kLongRow) {
      sum_wide(src, order, len, c, dst, lane);
    } else if (lane == 0) {
      long_rows[b * cap + atomicAdd(nlong + b, 1)] = e;
    }
  }
}

// The long rows (c > 32, more than kLongRow pixels, sorted by k5b_reduce):
// one block per (row, slice of kLongSlice channels), so that a row's slices
// run at once. The block loads the slice of the gradient rows of kLongPix
// pixels at a time (word w of a stage is channel w % slice of the stage's
// pixel w / slice: consecutive threads read consecutive words of a run of
// adjacent pixels) and stores it to shared memory; the slice's owners
// (threads 0 .. slice-1) add it in pixel order while the block already has
// the next stage's loads in flight.
__global__ void __launch_bounds__(kThreads)
    k5b_reduce_long(const float* __restrict__ grad_out, const int32_t* __restrict__ nlong,
                    const int4* __restrict__ long_rows, const int32_t* __restrict__ sorted,
                    float* __restrict__ grad, int n, int t, int c, int cap) {
  __shared__ float stage[kLongPix * kLongSlice];
  __shared__ int32_t pix[kLongPix];  // the ids of the stage being loaded
  const int64_t b = blockIdx.y;
  const int tid = threadIdx.x;
  const float* src = grad_out + b * n * c;
  const int slices = (c + kLongSlice - 1) / kLongSlice;
  const long long items = static_cast<long long>(nlong[b]) * slices;
  for (long long k = blockIdx.x; k < items; k += gridDim.x) {
    const int4 e = long_rows[b * cap + k / slices];  // {row, count, first place}
    const int c0 = static_cast<int>(k % slices) * kLongSlice;
    const int cs = min(kLongSlice, c - c0);
    const int len = e.y;
    const int32_t* order = sorted + b * n + e.z;
    const int step_j = kThreads / cs;
    const int step_ch = kThreads % cs;
    float v[kLongWords];
    // Loads the stage of pixels j0.. whose ids are in pix into v.
    const auto load = [&](int j0) {
      int j = tid / cs;
      int ch = tid % cs;
#pragma unroll
      for (int r = 0; r < kLongWords; ++r) {
        v[r] = j < kLongPix && j0 + j < len
                   ? __ldcs(src + static_cast<int64_t>(pix[j]) * c + c0 + ch)
                   : 0.0f;
        j += step_j;
        ch += step_ch;
        if (ch >= cs) {
          ch -= cs;
          ++j;
        }
      }
    };
    int next[kLongIds];  // the ids of the stage after the one being loaded
    __syncthreads();  // the previous item is done with pix and stage
#pragma unroll
    for (int i = 0; i < kLongIds; ++i) {
      const int q = tid + i * kThreads;
      if (q < kLongPix && q < len) pix[q] = order[q];
      next[i] = q < kLongPix && kLongPix + q < len ? order[kLongPix + q] : 0;
    }
    __syncthreads();
    load(0);
    float acc = 0.0f;
    for (int j0 = 0; j0 < len; j0 += kLongPix) {
      __syncthreads();  // the owners are done with the last stage
#pragma unroll
      for (int r = 0; r < kLongWords; ++r) {
        const int w = tid + r * kThreads;
        if (w < kLongPix * cs) stage[w] = v[r];
      }
#pragma unroll
      for (int i = 0; i < kLongIds; ++i) {
        if (tid + i * kThreads < kLongPix) pix[tid + i * kThreads] = next[i];
      }
      __syncthreads();
      if (j0 + kLongPix < len) {
        load(j0 + kLongPix);
#pragma unroll
        for (int i = 0; i < kLongIds; ++i) {
          const int q = j0 + 2 * kLongPix + tid + i * kThreads;
          next[i] = tid + i * kThreads < kLongPix && q < len ? order[q] : 0;
        }
      }
      if (tid < cs) {  // 8 shared loads ahead of each 8 adds
        const int m = min(kLongPix, len - j0);
        const float* col = stage + tid;
        int j = 0;
        for (; j + 8 <= m; j += 8) {
          float x[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) x[u] = col[(j + u) * cs];
#pragma unroll
          for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, x[u]);
        }
        for (; j < m; ++j) acc = __fadd_rn(acc, col[j * cs]);
      }
    }
    if (tid < cs) grad[(b * t + e.x) * c + c0 + tid] = acc;
  }
}

// The blocks of `kernel` (kRowWarps warps) that the current device holds at
// once, found once per device and kernel.
template <typename Kernel>
int resident_blocks(Kernel kernel, int which) {
  static int known[64][3];
  int dev = 0;
  cudaGetDevice(&dev);
  int& blocks = known[dev & 63][which];
  if (blocks == 0) {
    int sms = 0;
    int per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRowWarps * 32, 0);
    if (sms <= 0 || per_sm <= 0) return 1;  // not known: the launch's own check reports why
    blocks = sms * per_sm;
  }
  return blocks;
}

// The scratch layout of K5b, in int32 words: counts [b, t], the images'
// cursors [b], row counts [b] and long-row counts [b] (these four zeroed,
// padded to 4 words), rows and long_rows [b, min(t, n)] of int4 each, fill
// [b, t], ids [b, n], sorted [b, n].
long long k5b_zeroed_words(int b, int t) {
  return (static_cast<long long>(b) * t + 3LL * b + 3) / 4 * 4;
}

long long k5b_scratch_words(int b, long long n, int t) {
  return k5b_zeroed_words(b, t) + 8LL * b * std::min(static_cast<long long>(t), n) +
         static_cast<long long>(b) * t + 2LL * b * n;
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

// The int32 words of scratch that fovealseg_row_gather_backward needs.
extern "C" long long fovealseg_row_gather_backward_scratch(int b, long long n, int t) {
  return k5b_scratch_words(b, n, t);
}

// grad_out [b, n, c] float32, idx [b, n] int32, grad_table [b, t, c] float32
// (every word written: no fill needed), scratch of scratch_words int32 words,
// 16-byte aligned, at least fovealseg_row_gather_backward_scratch(b, n, t);
// all contiguous, with the forward's limits (checked by the Python wrapper).
// Five launches on the stream (six for c > 32), no synchronisation. Returns
// the launches' CUDA error.
extern "C" int fovealseg_row_gather_backward(const void* grad_out, const void* idx,
                                             void* grad_table, void* scratch,
                                             long long scratch_words, int b, long long n, int t,
                                             int c, void* stream_handle) {
  if (b <= 0 || n <= 0 || n >= (1LL << 31) || t <= 0 || c <= 0 || c > 65535 || b > 65535 ||
      scratch_words < k5b_scratch_words(b, n, t) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const auto* src = static_cast<const float*>(grad_out);
  const auto* ind = static_cast<const int32_t*>(idx);
  auto* dst = static_cast<float*>(grad_table);
  const int nn = static_cast<int>(n);
  const int cap = static_cast<int>(std::min(static_cast<long long>(t), n));
  const long long bt = static_cast<long long>(b) * t;
  int32_t* counts = static_cast<int32_t*>(scratch);
  int32_t* heads = counts + bt;
  int32_t* nrows = heads + b;
  int32_t* nlong = nrows + b;
  const long long zeroed = k5b_zeroed_words(b, t);
  auto* rows = reinterpret_cast<int4*>(counts + zeroed);  // zeroed % 4 == 0: 16-byte aligned
  int4* long_rows = rows + static_cast<long long>(b) * cap;
  int32_t* fill = counts + zeroed + 8LL * b * cap;
  int32_t* ids = fill + bt;
  int32_t* sorted = ids + static_cast<long long>(b) * n;
  const long long table_words = bt * c;
  k5b_zero<<<static_cast<unsigned>(
                 std::min((zeroed + table_words) / 4 / kThreads + 1, kZeroBlocks)),
             kThreads, 0, stream>>>(reinterpret_cast<uint32_t*>(counts), zeroed,
                                    static_cast<uint32_t*>(grad_table), table_words);
  const dim3 pix_grid(static_cast<unsigned>((n + kThreads - 1) / kThreads), b);
  const dim3 row_grid(static_cast<unsigned>((t + kThreads - 1LL) / kThreads), b);
  // the reduces: one wave of blocks whose warps stride over the rows
  const auto grid = [&](int resident) {
    return dim3(static_cast<unsigned>(std::min((cap + kRowWarps - 1LL) / kRowWarps,
                                               static_cast<long long>(std::max(1, resident / b)))),
                b);
  };
  k5b_count<<<pix_grid, kThreads, 0, stream>>>(ind, counts, nn, t);
  k5b_alloc<<<row_grid, kThreads, 0, stream>>>(counts, heads, nrows, fill, rows, t, cap);
  k5b_place<<<pix_grid, kThreads, 0, stream>>>(ind, fill, ids, nn, t);
  if (c > 32) {
    k5b_reduce<true><<<grid(resident_blocks(k5b_reduce<true>, 0)), kRowWarps * 32, 0, stream>>>(
        src, nrows, rows, nlong, long_rows, ids, sorted, dst, nn, t, c, cap);
    const int long_blocks = std::max(1, resident_blocks(k5b_reduce_long, 2) / b);
    const dim3 long_grid(static_cast<unsigned>(long_blocks), b);
    k5b_reduce_long<<<long_grid, kThreads, 0, stream>>>(src, nlong, long_rows, sorted, dst, nn, t,
                                                        c, cap);
  } else {
    k5b_reduce<false><<<grid(resident_blocks(k5b_reduce<false>, 1)), kRowWarps * 32, 0,
                        stream>>>(src, nrows, rows, nlong, long_rows, ids, sorted, dst, nn, t, c,
                                  cap);
  }
  return static_cast<int>(cudaGetLastError());
}
