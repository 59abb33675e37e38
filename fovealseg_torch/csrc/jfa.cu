// Jump flood for Hopper (sm_90a): every pixel gets its nearest valid seed's
// payload (class and payload modes) or flat index (seed mode).
//
// Replaces: fovealseg_tpu/ops/pallas_jfa.py::_jfa_kernel in all four modes:
//   'class'   nearest_class_pallas           (pallas_jfa.py:209)  K1
//   'relpay'  nearest_payload_packed_pallas  (pallas_jfa.py:226)  K2
//   'payload' nearest_payload_pallas         (pallas_jfa.py:194)  K3
//   'seed'    nearest_seed_pallas            (pallas_jfa.py:186)  K4
// Its results are bit-equal to that kernel's:
//   * rounds is clipped to [1, full], full = ceil(log2(max(H, W))); there are
//     rounds+1 trips with step k = max((1 << (rounds-1)) >> i, 1);
//   * within a trip the 8 directions (sy, sx) in {-1,0,1}^2 \ {(0,0)} run in
//     that loop order, each one reading the state the previous one wrote;
//   * the candidate at (r, c) is the seed held at (r + sy*k, c + sx*k); out of
//     range means no candidate; it wins iff its squared integer distance to
//     (r, c) is strictly below the current seed's;
//   * a pixel that no seed reaches gets 0.
//
// Why the four modes share the flood: the state here is the seed's position
// only, (y << 16) | x, or -1. The TPU modes differ in how they pack the
// payload into the rolled word, but every mode scans the same candidates in
// the same order with the same integer distance and the same strict '<', so
// the winning seed is the same. Only the last trip's store differs: the
// payload modes read the payload at the winner, the seed mode writes y*W + x.
// K1, K2 and K3 share one entry point (fovealseg_jfa_nearest_payload), K4 has
// its own (fovealseg_jfa_nearest_seed).
//
// One launch per trip. A trip at step k couples only pixels of one residue
// class (y mod k, x mod k); each class is a small image, the stride-k
// sublattice, on which the 8 directions are a 3x3-neighbour stencil applied 8
// times in order. After the 8 directions, a cell depends only on the trip's
// starting state within 3 cells of it (the sums of any subset of the 8
// offsets lie in [-3, 3]^2). So a tile of the sublattice loaded with a 3-cell
// halo and updated 8 times in shared memory is exact in its window:
//   * a tile is one image, a block of Ry x Rx classes (t, the x residue,
//     fastest, so a loaded row is Rx*(TB+6) contiguous pixels when Rx = k
//     and at least 16 bytes otherwise) and a TA x TB window of sublattice
//     points, held with its halo in a flat shared array (t, then b, a, u) of
//     at most 8192 cells, 8 to each of the block's 1024 threads;
//   * each direction is a Jacobi step over the tile: every thread reads the
//     candidates of its cells from one buffer, keeps seed and distance in
//     registers and writes the seeds to the other buffer; one barrier;
//   * a cell off the canvas holds -1 and is never updated. (If it were, a
//     halo cell past the border could take a seed from the canvas and hand it
//     to a pixel through a candidate that the semantics treat as out of
//     range.) A halo cell at the tile's edge reads a neighbour of another
//     class or the -1 padding; no window cell depends on that value;
//   * where the window holds whole classes, everything past a class is off
//     the canvas and a 1-cell ring of such cells is halo enough;
//   * where a class's whole extent fits in E x E (E = 2 or 3), one thread
//     floods the whole class in registers, with no halo and no barrier.
// The tile table (tile() below, mirrored by ops/jfa.py::TILES) has each
// step's own tiles (halo 3) and four whole-class tiles (halo 1); a trip takes
// its step's own tiles or, where cheaper, whole-class tiles, by the cells
// computed (a tile's cells count in whole rounds of the block). At 640x640:
//   k =   1: own,   1 x  1 classes, 72 x 92 window   (1.26 cells per pixel)
//   k =   2: own,   1 x  2 classes, 40 x 80          (1.28)
//   k =   4: own,   1 x  4 classes, 32 x 40          (1.40)
//   k =   8: own,   1 x  8 classes, 16 x 40          (1.60)
//   k =  16: whole, 1 x  4 classes, 40 x 40, halo 1  (1.12)
//   k =  32: whole, 1 x  8 classes, 20 x 20          (1.28)
//   k =  64: whole, 1 x 32 classes, 10 x 10          (1.60)
//   k = 128: whole, 4 x 32 classes,  5 x  5          (2.24)
//   k >= 256: one class per thread, in registers.
// The runtime rounds of the flagship (5) take k = 16 ... 1; a full chain
// (K3, K4: 10 rounds) starts at k = 512.
//
// Launches and buffers. The round count is a device scalar (it comes from the
// grid on the device), so the host launches the trips of every possible
// count, full + 1, on a persistent grid (as many blocks as fit on the card at
// once, each looping over tiles); a trip past the count returns at once from
// that small grid. Trip i writes buffer (r - i) & 1 of {out, scratch} and
// reads the other, so trip r writes `out`; trip 0 builds the seeds from
// `valid` as it loads, and trip r stores the payload or flat index in place
// of the seed. No init or finalize launch, no host synchronisation, no grid
// barrier. A thread issues all its cells' loads before it uses any.
//
// What bounds it. The least traffic of the function at b8 640x640 is the
// valid mask (3.3 MB as bool) + payload (13.1 MB) + output (13.1 MB), about
// 29.5 MB or 9 us at 3.35 TB/s (the seed mode reads no payload: 16.4 MB,
// 5 us). The design's own floor is r+1 trips each reading and writing the
// 13.1 MB state: 157 MB at the flagship's 5 runtime rounds, 47 us at HBM
// rate, less where the state stays in the 50 MB L2. A cell costs 12
// instructions per direction (one shared load and store, the distance, the
// compare), ~100 per trip with the halo, so a trip is bound by instruction
// issue and barriers rather than bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kCellsPerThread = 8;
constexpr int kMaxCells = kThreads * kCellsPerThread;
constexpr int kPad = 576;  // >= the largest neighbour offset of any tile, (TB+2*halo)*Rx + Rx
constexpr int kBuf = kPad + kMaxCells + kPad;
constexpr size_t kSmemBytes = 2 * kBuf * sizeof(int32_t);
constexpr int32_t kNoSeed = -1;
// Distances are unsigned: no seed is as far as can be, and a cell that must
// not change (off the canvas) has distance 0, which no candidate beats.
constexpr unsigned kFar = 0xffffffffu;
constexpr unsigned kFrozen = 0u;

struct Trip {
  const uint8_t* valid;    // trip 0 builds the seeds from this
  const int32_t* src;      // the other trips read the state here
  int32_t* dst;
  const int32_t* payload;  // read by the last trip, null in seed mode
  int k, b, h, w;
  bool first, last;
};

// Squared distance from the seed at (y, x) packed in `seed` to the cell at
// `yx`; both are (y << 16) | x with x < 32768, so the packed difference holds
// dy in its high half and dx, signed, in its low half.
__device__ __forceinline__ unsigned dist2(int32_t seed, int32_t yx) {
  const int diff = seed - yx;
  const int dx = static_cast<int16_t>(diff & 0xffff);
  const int dy = (diff - dx) >> 16;
  return static_cast<unsigned>(dx * dx) + static_cast<unsigned>(dy * dy);
}

__device__ __forceinline__ void relax(int32_t cand, int32_t yx, int32_t& cur, unsigned& best) {
  const unsigned d = dist2(cand, yx);
  if (cand >= 0 && d < best) {
    cur = cand;
    best = d;
  }
}

// Position word of the pixel (y, x): exact on the canvas, never read off it.
__device__ __forceinline__ int32_t pos(int y, int x) {
  return static_cast<int32_t>((static_cast<unsigned>(y) << 16) | static_cast<unsigned>(x));
}

// The trip's starting state of N cells of one plane at flat offsets `off`
// (0 for cells off the canvas, which get -1): all loads issue before any is
// used.
template <int N>
__device__ __forceinline__ void load_cells(const Trip& p, size_t plane, const int (&off)[N],
                                           const int32_t (&yx)[N], uint32_t on,
                                           int32_t (&cur)[N]) {
  if (p.first) {
    const uint8_t* v = p.valid + plane;
#pragma unroll
    for (int j = 0; j < N; ++j) cur[j] = v[off[j]] ? yx[j] : kNoSeed;
  } else {
    const int32_t* v = p.src + plane;
#pragma unroll
    for (int j = 0; j < N; ++j) cur[j] = __ldg(v + off[j]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (!((on >> j) & 1)) cur[j] = kNoSeed;
}

// Store the cells in `mask` at their positions `yx`: the state after the
// trip, or on the last trip the winner's payload or flat index (0 where no
// seed was reached).
template <int N>
__device__ __forceinline__ void store_cells(const Trip& p, size_t plane, const int32_t (&yx)[N],
                                            uint32_t mask, const int32_t (&cur)[N]) {
  int32_t v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int32_t flat = cur[j] >= 0 ? (cur[j] >> 16) * p.w + (cur[j] & 0xffff) : 0;
    v[j] = cur[j];
    if (p.last) v[j] = flat;
  }
  if (p.last && p.payload != nullptr) {
    const int32_t* pay = p.payload + plane;
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = __ldg(pay + v[j]);  // every index is on the canvas
  }
  if (p.last) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (cur[j] < 0) v[j] = 0;
  }
  int32_t* dst = p.dst + plane;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if ((mask >> j) & 1) dst[(yx[j] >> 16) * p.w + (yx[j] & 0xffff)] = v[j];
}

// Direction d of the 8, in the semantics' loop order.
__host__ __device__ constexpr int dir_y(int d) { return d < 3 ? -1 : d < 5 ? 0 : 1; }
__host__ __device__ constexpr int dir_x(int d) {
  return d < 3 ? d - 1 : d == 3 ? -1 : d == 4 ? 1 : d - 6;
}

// The tile table, mirrored by fovealseg_torch/ops/jfa.py::TILES: rows 0-5
// are each step's own tiles by log2(k) (k >= 32 shares row 5), rows 6-9 the
// whole-class tiles.
struct Tile {
  int ry, rx, ta, tb, halo;
};
constexpr int kOwnTiles = 6, kTiles = 10;
__host__ __device__ constexpr Tile tile(int i) {
  return i == 0 ? Tile{1, 1, 72, 92, 3}
       : i == 1 ? Tile{1, 2, 40, 80, 3}
       : i == 2 ? Tile{1, 4, 32, 40, 3}
       : i == 3 ? Tile{1, 8, 16, 40, 3}
       : i == 4 ? Tile{1, 16, 13, 20, 3}
       : i == 5 ? Tile{1, 32, 10, 10, 3}
       : i == 6 ? Tile{4, 32, 5, 5, 1}
       : i == 7 ? Tile{1, 32, 10, 10, 1}
       : i == 8 ? Tile{1, 8, 20, 20, 1}
                : Tile{1, 4, 40, 40, 1};
}

// Cells the trip computes with tile t (a tile's cells in whole rounds of the
// block), or -1 where t does not apply: more classes than the step has, or
// a halo-1 window that does not hold a whole class.
__device__ int64_t tile_cost(const Tile& t, const Trip& p) {
  const int k = p.k;
  const int ea = (p.h + k - 1) / k, eb = (p.w + k - 1) / k;
  if (t.ry > k || t.rx > k || (t.halo == 1 && (t.ta < ea || t.tb < eb))) return -1;
  const int64_t tiles = static_cast<int64_t>(p.b) * ((min(k, p.h) + t.ry - 1) / t.ry) *
                        ((min(k, p.w) + t.rx - 1) / t.rx) * ((ea + t.ta - 1) / t.ta) *
                        ((eb + t.tb - 1) / t.tb);
  const int cells = t.ry * t.rx * (t.ta + 2 * t.halo) * (t.tb + 2 * t.halo);
  return tiles * ((cells + kThreads - 1) / kThreads) * kThreads;
}

// One trip over the tiles of row I of the table (see the note).
template <int I>
__device__ void flood_tiles(const Trip& p, int32_t* s0, int32_t* s1) {
  constexpr Tile T = tile(I);
  constexpr int RY = T.ry, RX = T.rx, TA = T.ta, TB = T.tb, HALO = T.halo;
  constexpr int TAS = TA + 2 * HALO;
  constexpr int TBS = TB + 2 * HALO;
  constexpr int ROW = TBS * RX;  // flat offset of the next sublattice row
  constexpr int CELLS = RY * TAS * ROW;
  static_assert(CELLS <= kMaxCells, "tile larger than the block holds");
  static_assert(ROW + RX <= kPad, "padding smaller than a neighbour offset");
  const int k = p.k;
  const int ryb = (min(k, p.h) + RY - 1) / RY;
  const int rxb = (min(k, p.w) + RX - 1) / RX;
  const int aw = ((p.h + k - 1) / k + TA - 1) / TA;
  const int bw = ((p.w + k - 1) / k + TB - 1) / TB;
  const int tiles = p.b * ryb * rxb * aw * bw;
  for (int id = blockIdx.x; id < tiles; id += gridDim.x) {
    int rest = id;
    const int bi = rest % bw;
    rest /= bw;
    const int ai = rest % aw;
    rest /= aw;
    const int rxi = rest % rxb;
    rest /= rxb;
    const int ryi = rest % ryb;
    const size_t plane = static_cast<size_t>(rest / ryb) * p.h * p.w;
    // pixel of cell (u, a, b, t) = (y0 + u + k*a, x0 + t + k*b)
    const int y0 = ryi * RY + k * (ai * TA - HALO);
    const int x0 = rxi * RX + k * (bi * TB - HALO);

    // Cell j of this thread exists if j * kThreads < CELLS; the others are
    // left out at compile time and their slots keep the -1 they started with.
    int32_t cur[kCellsPerThread], yx[kCellsPerThread];
    unsigned best[kCellsPerThread];
    uint32_t on = 0, window = 0;
    {
      int off[kCellsPerThread];
#pragma unroll
      for (int j = 0; j < kCellsPerThread; ++j) {
        // Opaque, so that the cell's place in the tile is worked out in every
        // tile: held across tiles, the cells' places spill.
        unsigned c = threadIdx.x + j * kThreads;
        asm volatile("" : "+r"(c));
        const int a = (c / ROW) % TAS;
        const int b = (c / RX) % TBS;
        const int y = y0 + static_cast<int>(c / (ROW * TAS)) + k * a;
        const int x = x0 + static_cast<int>(c % RX) + k * b;
        const bool in = j * kThreads < CELLS && c < CELLS && y >= 0 && y < p.h && x >= 0 &&
                        x < p.w;
        on |= static_cast<uint32_t>(in) << j;
        window |= static_cast<uint32_t>(in && a >= HALO && a < HALO + TA && b >= HALO &&
                                        b < HALO + TB) << j;
        off[j] = in ? y * p.w + x : 0;
        yx[j] = pos(y, x);
      }
      load_cells(p, plane, off, yx, on, cur);
    }
#pragma unroll
    for (int j = 0; j < kCellsPerThread; ++j) {
      best[j] = !((on >> j) & 1) ? kFrozen : cur[j] >= 0 ? dist2(cur[j], yx[j]) : kFar;
      if (j * kThreads < CELLS) s0[kPad + threadIdx.x + j * kThreads] = cur[j];
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int32_t* from = (d & 1) ? s1 : s0;
      int32_t* to = (d & 1) ? s0 : s1;
#pragma unroll
      for (int j = 0; j < kCellsPerThread; ++j) {
        const int c = threadIdx.x + j * kThreads;
        if (j * kThreads < CELLS)
          relax(from[kPad + c + dir_y(d) * ROW + dir_x(d) * RX], yx[j], cur[j], best[j]);
      }
      if (d < 7) {  // the last direction's result goes to global memory
#pragma unroll
        for (int j = 0; j < kCellsPerThread; ++j)
          if (j * kThreads < CELLS) to[kPad + threadIdx.x + j * kThreads] = cur[j];
        __syncthreads();
      }
    }
    store_cells(p, plane, yx, window, cur);
  }
}

// One trip where every class fits in E x E: one thread per class, whole, its
// cells in registers (cell (a, b) is number a*E + b). A direction updates the
// cells in place, in the order that reads every candidate before it changes
// (rows upward when reading the row above, and so on), which is the Jacobi
// step without a copy. I indexes the classes of the batch: 32-bit where they
// fit, since a 64-bit division is many times slower.
template <int E, typename I>
__device__ void flood_classes_as(const Trip& p, I classes) {
  constexpr int N = E * E;
  const int k = p.k;
  const int ncy = min(k, p.h), ncx = min(k, p.w);
  for (I id = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x; id < classes;
       id += static_cast<I>(gridDim.x) * blockDim.x) {
    const int rx = static_cast<int>(id % ncx);
    const I rest = id / ncx;
    const int ry = static_cast<int>(rest % ncy);
    const size_t plane = static_cast<size_t>(rest / ncy) * p.h * p.w;
    int32_t cur[N], yx[N];
    unsigned best[N];
    uint32_t on = 0;
    {
      int off[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int y = ry + k * (i / E), x = rx + k * (i % E);
        const bool in = y < p.h && x < p.w;
        on |= static_cast<uint32_t>(in) << i;
        off[i] = in ? y * p.w + x : 0;
        yx[i] = pos(y, x);
      }
      load_cells(p, plane, off, yx, on, cur);
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      best[i] = !((on >> i) & 1) ? kFrozen : cur[i] >= 0 ? dist2(cur[i], yx[i]) : kFar;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int a = dir_y(d) < 0 ? E - 1 - i : i;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int b = dir_y(d) == 0 && dir_x(d) < 0 ? E - 1 - j : j;
          const int ca = a + dir_y(d), cb = b + dir_x(d);
          if (ca >= 0 && ca < E && cb >= 0 && cb < E)
            relax(cur[ca * E + cb], yx[a * E + b], cur[a * E + b], best[a * E + b]);
        }
      }
    }
    store_cells(p, plane, yx, on, cur);
  }
}

template <int E>
__device__ void flood_classes(const Trip& p) {
  const int64_t classes = static_cast<int64_t>(p.b) * min(p.k, p.h) * min(p.k, p.w);
  if (classes <= INT32_MAX)
    flood_classes_as<E, uint32_t>(p, static_cast<uint32_t>(classes));
  else
    flood_classes_as<E, int64_t>(p, classes);
}

__global__ void __launch_bounds__(kThreads, 1)
    jfa_trip(const uint8_t* __restrict__ valid, const int32_t* __restrict__ payload,
             int32_t* out, int32_t* scratch, const int32_t* __restrict__ rounds, int trip, int b,
             int h, int w, int full) {
  const int r = min(max(rounds[0], 1), full);
  if (trip > r) return;  // trips are i = 0 .. r
  Trip p;
  p.valid = valid;
  p.payload = payload;
  p.dst = ((r - trip) & 1) ? scratch : out;
  p.src = ((r - trip) & 1) ? out : scratch;
  p.k = max((1 << (r - 1)) >> trip, 1);
  p.b = b;
  p.h = h;
  p.w = w;
  p.first = trip == 0;
  p.last = trip == r;

  const int extent = (max(h, w) + p.k - 1) / p.k;
  if (extent <= 2) return flood_classes<2>(p);
  if (extent <= 3) return flood_classes<3>(p);

  // The step's own tiles, or the cheapest whole-class tiles that apply.
  int choice = min(31 - __clz(p.k), kOwnTiles - 1);
  int64_t cost = tile_cost(tile(choice), p);
  for (int i = kOwnTiles; i < kTiles; ++i) {
    const int64_t c = tile_cost(tile(i), p);
    if (c >= 0 && c < cost) {
      choice = i;
      cost = c;
    }
  }
  extern __shared__ int32_t smem[];
  int32_t* s0 = smem;
  int32_t* s1 = smem + kBuf;
  // Slots past a tile's cells and the padding are read by halo cells and
  // hold -1 for the whole launch.
  for (int i = threadIdx.x; i < 2 * kBuf; i += kThreads) smem[i] = kNoSeed;
  __syncthreads();
  switch (choice) {
    case 0: return flood_tiles<0>(p, s0, s1);
    case 1: return flood_tiles<1>(p, s0, s1);
    case 2: return flood_tiles<2>(p, s0, s1);
    case 3: return flood_tiles<3>(p, s0, s1);
    case 4: return flood_tiles<4>(p, s0, s1);
    case 5: return flood_tiles<5>(p, s0, s1);
    case 6: return flood_tiles<6>(p, s0, s1);
    case 7: return flood_tiles<7>(p, s0, s1);
    case 8: return flood_tiles<8>(p, s0, s1);
    default: return flood_tiles<9>(p, s0, s1);
  }
}

// Blocks of the persistent grid on the current device: as many as fit at
// once. Sets the kernel's shared-memory limit on first use.
cudaError_t grid_blocks(int* blocks) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(jfa_trip, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, jfa_trip, kThreads, kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = (per_sm > 0 ? per_sm : 1) * sms;
  if (dev < 64) cached[dev] = *blocks;
  return cudaSuccess;
}

int flood(const void* valid, const void* payload, void* out, void* scratch, const void* rounds,
          int b, int h, int w, int full, void* stream_handle) {
  int blocks = 0;
  const cudaError_t err = grid_blocks(&blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  for (int trip = 0; trip <= full; ++trip)
    jfa_trip<<<blocks, kThreads, kSmemBytes, stream>>>(
        static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(payload),
        static_cast<int32_t*>(out), static_cast<int32_t*>(scratch),
        static_cast<const int32_t*>(rounds), trip, b, h, w, full);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1, K2 and K3: valid [b,h,w] bool (1 byte), payload [b,h,w] int32 (any
// value), out [b,h,w] int32, scratch [b,h,w] int32, rounds [1] int32 on the
// device. All contiguous, h, w < 32768, b < 65536 (checked by the Python
// wrapper).
extern "C" int fovealseg_jfa_nearest_payload(const void* valid, const void* payload, void* out,
                                             void* scratch, const void* rounds, int b, int h,
                                             int w, int full, void* stream_handle) {
  return flood(valid, payload, out, scratch, rounds, b, h, w, full, stream_handle);
}

// K4: valid, out, scratch and rounds as above; no payload.
extern "C" int fovealseg_jfa_nearest_seed(const void* valid, void* out, void* scratch,
                                          const void* rounds, int b, int h, int w, int full,
                                          void* stream_handle) {
  return flood(valid, nullptr, out, scratch, rounds, b, h, w, full, stream_handle);
}
