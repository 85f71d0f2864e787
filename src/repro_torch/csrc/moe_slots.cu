// The MoE dispatch's slot positions for Hopper (sm_90a), hand-written CUDA
// C++.
//
// Replaces: src/repro/models/moe.py:116-119 (jnp: a one-hot of each slot's
//           expert, an exclusive cumsum over the group's slots, and the
//           position, keep flag and slot that follow from it).
//
// eid (BG, N) int64 holds the expert of each (token, k) slot of BG dispatch
// groups, token-major. pos, a slot's position within its expert, is the
// number of earlier slots of its group with the same expert. From it:
//   slot = eid * C + min(pos, C - 1)                         (BG, N) int64
//   keep = pos < C                                           (BG, N) bool
//   dest = (keep ? slot : Ee * C) + bg * (Ee * C + 1)        (BG, N) int64
//   kept[bg][e] = min(slots of expert e in group bg, C)      (BG, Ee) int32
// An expert outside [0, Ee) is counted by no expert and gets pos 0, as the
// one-hot formula gives it (the router never makes one).
//
// What bounds it on the card: bytes, and barely. It reads 8 B and writes
// 17 B a slot; at 98,304 slots (a 16k-token prompt, top-6, one group) that
// is 2.5 MB, about 0.73 us at 3.35 TB/s; a launch costs more. A scan along
// the slot axis with one thread a (group, expert) column, as ATen's cumsum
// over a non-innermost axis runs, walks those 98,304 steps one after
// another; this kernel has no serial walk longer than a warp's ITEMS
// steps.
//
// Design:
//   * tiles of TILE = THREADS * ITEMS slots; warp w of a tile owns the
//     contiguous slots [w * 32 * ITEMS, (w + 1) * 32 * ITEMS) of it, in
//     ITEMS steps of 32 consecutive slots (lane l takes slot 32 i + l);
//   * a step ranks its 32 slots with __match_any_sync (the lanes of the
//     same expert) and __popc over the lower lanes of that set; the lowest
//     such lane adds the set's size to the warp's own count of that expert
//     in shared memory. A lane keeps each slot's rank within its warp;
//   * the warps' counts are turned, expert by expert, into an exclusive
//     prefix over the warps, on top of the count of the earlier tiles of
//     the group: then pos = that prefix + the rank;
//   * the earlier tiles' counts come from a first launch (only when a group
//     spans more than one tile): each tile but the group's last counts its
//     slots the same way and writes its histogram, (BG, tiles - 1, Ee)
//     int32, to a scratch buffer; the second launch's CTA of tile t sums
//     the histograms of tiles 0 .. t-1 (shared-memory integer atomics).
//     Decode (its batch routed as one group of 64-192 slots) and training
//     (groups of 1,536) are one tile a group and one launch; a 16k prompt
//     (N = 98,304) is 48 tiles in one group, two launches of 47 and 48
//     CTAs;
//   * the group's last tile writes kept, the group's count clamped to C;
//   * only integers are summed, so the result is the same in any order of
//     the atomics: two calls give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;                   // slots a lane
constexpr int TILE = THREADS * ITEMS;      // slots a CTA
constexpr int MAX_EXPERTS = 1024;          // (WARPS + 1) * Ee ints shared

struct Params {
  const long long* eid;
  long long* slot;
  unsigned char* keep;
  long long* dest;
  int* kept;
  int* hist;        // (BG, tiles - 1, Ee): the counting launch's histograms
  long long N, C;
  int Ee, tiles;
};

// RANK false: count the slots of tile t < tiles - 1 into hist. RANK true:
// rank every slot of tile t and write slot, keep, dest (and kept in the
// group's last tile).
template <bool RANK>
__global__ void __launch_bounds__(THREADS) moe_slots_kernel(Params p) {
  extern __shared__ int smem[];
  const int Ee = p.Ee;
  int* counts = smem;                      // [WARPS][Ee]
  int* earlier = smem + WARPS * Ee;        // [Ee]: earlier tiles' slots
  const int nt = RANK ? p.tiles : p.tiles - 1;
  const long long bg = blockIdx.x / nt;
  const int t = blockIdx.x % nt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const long long* row = p.eid + bg * p.N;
  const long long first =
      (long long)t * TILE + (long long)warp * 32 * ITEMS + lane;
  long long ev[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long n = first + 32 * i;
    ev[i] = n < p.N ? row[n] : -1;
  }
  for (int i = threadIdx.x; i < (WARPS + 1) * Ee; i += THREADS) smem[i] = 0;
  __syncthreads();
  if (RANK) {
    const int* h = p.hist + bg * (p.tiles - 1) * (long long)Ee;
    for (int i = threadIdx.x; i < t * Ee; i += THREADS)
      atomicAdd(&earlier[i % Ee], h[i]);
  }

  int* mine = counts + warp * Ee;
  const unsigned lower = (1u << lane) - 1u;
  int rank[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool in = ev[i] >= 0 && ev[i] < Ee;
    const int e = in ? int(ev[i]) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    const int r = __popc(peers & lower);
    const int before = in ? mine[e] : 0;
    __syncwarp();
    if (in && r == 0) mine[e] = before + __popc(peers);
    __syncwarp();
    rank[i] = before + r;
  }
  __syncthreads();

  // per expert: each warp's count becomes the count of the slots before
  // the warp's first one (earlier tiles, then earlier warps)
  for (int e = threadIdx.x; e < Ee; e += THREADS) {
    int s = RANK ? earlier[e] : 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = counts[w * Ee + e];
      counts[w * Ee + e] = s;
      s += c;
    }
    if (!RANK)
      p.hist[(bg * (p.tiles - 1) + t) * Ee + e] = s;
    else if (t == p.tiles - 1)
      p.kept[bg * Ee + e] = int(s < p.C ? s : p.C);
  }
  if (!RANK) return;
  __syncthreads();

  const long long drop = (long long)Ee * p.C;
  const long long offset = bg * (drop + 1);
  const long long out0 = bg * p.N;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long n = first + 32 * i;
    if (n >= p.N) continue;
    const bool in = ev[i] >= 0 && ev[i] < Ee;
    const long long pos = in ? (long long)(mine[int(ev[i])] + rank[i]) : 0;
    const bool kp = pos < p.C;
    const long long s = ev[i] * p.C + (kp ? pos : p.C - 1);
    p.slot[out0 + n] = s;
    p.keep[out0 + n] = kp;
    p.dest[out0 + n] = (kp ? s : drop) + offset;
  }
}

}  // namespace

extern "C" {

// slots a tile: a group of N slots spans ceil(N / TILE) tiles
int moe_slots_tile() { return TILE; }

int moe_slots(const void* eid, void* slot, void* keep, void* dest,
              void* kept, void* hist, long long BG, long long N, int Ee,
              long long C, void* stream) {
  if (Ee <= 0 || Ee > MAX_EXPERTS || C <= 0 || BG < 0 || N < 0 ||
      N > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  if (BG == 0 || N == 0) return 0;
  const long long tiles = (N + TILE - 1) / TILE;
  if (BG * tiles > 0x7fffffffLL || (tiles > 1 && hist == nullptr))
    return int(cudaErrorInvalidValue);
  Params p;
  p.eid = static_cast<const long long*>(eid);
  p.slot = static_cast<long long*>(slot);
  p.keep = static_cast<unsigned char*>(keep);
  p.dest = static_cast<long long*>(dest);
  p.kept = static_cast<int*>(kept);
  p.hist = static_cast<int*>(hist);
  p.N = N;
  p.C = C;
  p.Ee = Ee;
  p.tiles = int(tiles);
  const size_t smem = size_t(WARPS + 1) * Ee * sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles > 1)
    moe_slots_kernel<false><<<unsigned(BG * (tiles - 1)), THREADS, smem, s>>>(
        p);
  moe_slots_kernel<true><<<unsigned(BG * tiles), THREADS, smem, s>>>(p);
  return int(cudaGetLastError());
}

const char* moe_slots_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
