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
// Why the four modes share the passes: the state here is the seed's position
// only, (y << 16) | x, or -1. The TPU modes differ in how they pack the
// payload into the rolled word (in the seed word, as relative offsets beside
// it, or as a second array), but every mode scans the same candidates in the
// same order with the same integer distance and the same strict '<', so the
// winning seed is the same. Only the final pass differs: the payload modes
// read the payload once at the winner, the seed mode writes y*W + x. The
// relative-offset packing of 'relpay' and its 7-round cap exist to roll one
// int32 on the TPU; a position-only state has neither limit, so K1, K2 and
// K3 share one entry point (fovealseg_jfa_nearest_payload) and K4 has its own
// (fovealseg_jfa_nearest_seed).
//
// What bounds it: bytes. At b8 640x640 the least traffic is the valid mask
// (3.3 MB as bool) + payload (13.1 MB) + output (13.1 MB), about 29.5 MB or
// 9 us at 3.35 TB/s; the seed mode reads no payload (16.4 MB, 5 us). The
// sequential direction order is what makes this hard: one pass per round
// that applies all 8 directions at once (the usual GPU JFA) picks other
// winners, so this design runs one pass per direction, 8*(rounds+1) passes,
// ping-ponging between the output buffer and one scratch buffer. Each pass
// moves about 2 x 13.1 MB, which stays resident in the 50 MB L2, so the
// passes run at L2 rather than HBM rate.
//
// The round count is a device scalar (it comes from the grid on the device).
// The host launches the passes of every possible round (full + 1); a pass
// whose round is past the count returns at once. Rounds come in groups of 8
// passes, an even number, so the state is back in the output buffer after
// every round and the buffer holding the result does not depend on how many
// passes did work. No host synchronisation is needed.
//
// Later work: a persistent cooperative kernel, or shared-memory tiles with
// halos for the small steps, would cut the launches and the L2 traffic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int32_t kNoSeed = -1;
constexpr int32_t kFar = 0x7fffffff;

__device__ __forceinline__ int dist2(int32_t seed, int y, int x) {
  const int dy = (seed >> 16) - y;
  const int dx = (seed & 0xffff) - x;
  return dy * dy + dx * dx;
}

__global__ void jfa_init(const uint8_t* __restrict__ valid, int32_t* __restrict__ state,
                         int h, int w) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t i = (static_cast<size_t>(blockIdx.z) * h + y) * w + x;
  state[i] = valid[i] ? ((y << 16) | x) : kNoSeed;
}

__global__ void jfa_pass(const int32_t* __restrict__ src, int32_t* __restrict__ dst,
                         const int32_t* __restrict__ rounds, int round, int sy, int sx,
                         int h, int w, int full) {
  const int r = min(max(rounds[0], 1), full);
  if (round > r) return;  // trips are i = 0 .. r
  const int k = max((1 << (r - 1)) >> round, 1);
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  const int32_t cur = src[plane + static_cast<size_t>(y) * w + x];
  int32_t out = cur;
  const int cy = y + sy * k;
  const int cx = x + sx * k;
  if (cy >= 0 && cy < h && cx >= 0 && cx < w) {
    const int32_t cand = src[plane + static_cast<size_t>(cy) * w + cx];
    if (cand >= 0) {
      const int best = cur >= 0 ? dist2(cur, y, x) : kFar;
      if (dist2(cand, y, x) < best) out = cand;
    }
  }
  dst[plane + static_cast<size_t>(y) * w + x] = out;
}

// Payload modes: the winner's payload, 0 where no seed was reached.
__global__ void jfa_finalize_payload(int32_t* __restrict__ state_out,
                                     const int32_t* __restrict__ payload, int h, int w) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  const size_t i = plane + static_cast<size_t>(y) * w + x;
  const int32_t s = state_out[i];
  state_out[i] = s >= 0 ? payload[plane + static_cast<size_t>(s >> 16) * w + (s & 0xffff)] : 0;
}

// Seed mode: the winner's flat index y*W + x, 0 where no seed was reached.
__global__ void jfa_finalize_seed(int32_t* __restrict__ state_out, int h, int w) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t i = (static_cast<size_t>(blockIdx.z) * h + y) * w + x;
  const int32_t s = state_out[i];
  state_out[i] = s >= 0 ? (s >> 16) * w + (s & 0xffff) : 0;
}

// Seeds from `valid`, then every pass; the winners' positions end in `out`.
void flood(const void* valid, int32_t* out, int32_t* scratch, const int32_t* rounds, int h,
           int w, int full, cudaStream_t stream, dim3 grid, dim3 block) {
  jfa_init<<<grid, block, 0, stream>>>(static_cast<const uint8_t*>(valid), out, h, w);
  for (int round = 0; round <= full; ++round) {
    int pass = 0;
    for (int sy = -1; sy <= 1; ++sy) {
      for (int sx = -1; sx <= 1; ++sx) {
        if (sy == 0 && sx == 0) continue;
        const int32_t* src = (pass % 2 == 0) ? out : scratch;
        int32_t* dst = (pass % 2 == 0) ? scratch : out;
        jfa_pass<<<grid, block, 0, stream>>>(src, dst, rounds, round, sy, sx, h, w, full);
        ++pass;
      }
    }
  }
}

dim3 grid_of(int b, int h, int w) {
  return dim3((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, b);
}

}  // namespace

// K1, K2 and K3: valid [b,h,w] bool (1 byte), payload [b,h,w] int32 (any
// value), out [b,h,w] int32, scratch [b,h,w] int32, rounds [1] int32 on the
// device. All contiguous, h, w < 32768, b < 65536 (checked by the Python
// wrapper).
extern "C" int fovealseg_jfa_nearest_payload(const void* valid, const void* payload, void* out,
                                             void* scratch, const void* rounds, int b, int h,
                                             int w, int full, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid = grid_of(b, h, w);
  int32_t* a = static_cast<int32_t*>(out);
  flood(valid, a, static_cast<int32_t*>(scratch), static_cast<const int32_t*>(rounds), h, w, full,
        stream, grid, block);
  jfa_finalize_payload<<<grid, block, 0, stream>>>(a, static_cast<const int32_t*>(payload), h, w);
  return static_cast<int>(cudaGetLastError());
}

// K4: valid, out, scratch and rounds as above; no payload.
extern "C" int fovealseg_jfa_nearest_seed(const void* valid, void* out, void* scratch,
                                          const void* rounds, int b, int h, int w, int full,
                                          void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid = grid_of(b, h, w);
  int32_t* a = static_cast<int32_t*>(out);
  flood(valid, a, static_cast<int32_t*>(scratch), static_cast<const int32_t*>(rounds), h, w, full,
        stream, grid, block);
  jfa_finalize_seed<<<grid, block, 0, stream>>>(a, h, w);
  return static_cast<int>(cudaGetLastError());
}
