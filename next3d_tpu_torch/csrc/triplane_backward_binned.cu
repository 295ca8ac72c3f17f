// K4's backward for planes stored in bf16 on Hopper (sm_90a): the points
// binned by plane tile, and each texel's bf16 gradient written once from
// shared memory.
//
// Replaces, for bf16 planes, the gradient of the TPU kernel
// next3d_tpu/ops/pallas_triplane.py triplane_sample_tiles, which is forward
// only: the JAX package trains its bf16 gather (gather_bf16,
// render/renderer.py:50-65) by XLA's VJP of the gather, in bf16. The
// function is the transpose of the forward: every (point, plane, in-range
// tap) adds its bilinear weight times the point's output gradient into its
// texel. The sums are float32, each rounded once to bf16 (nearest even), as
// ops/triplane.py triplane_sample_backward_plain(...).to(torch.bfloat16)
// computes them.
//
// What bounds it on the H100: bytes. At a 512^2 pass (N = 4, M = 196,608,
// C = 32) it must read 302 MB of grad_out and 9.4 MB of points and write
// 50.3 MB of bf16 gradient: 0.108 ms at 3.35 TB/s. The float32 kernel of
// triplane_sample.cu scatters with float4 atomics into a zero-filled
// float32 gradient, which the L2's atomic rate holds at about 4x that, and
// a cast then reads the float32 gradient again.
//
// Design: sort the points by where they land, then write each texel once.
// Five launches after a memset of the tile counts:
//   count    kPointsPerBlock consecutive points a block: on each plane a
//            point's cell (cell_of, the float32 kernel's and
//            ops/triplane.py _cells' rounding) and the kTile x kTile tiles
//            of its (image, plane) that its in-range taps touch (1, 2 or
//            4). A run of a warp's lanes with the same tile adds its length
//            once to the block's shared-memory counts; the block adds each
//            count to the tile's once (global atomics are few: their rate
//            at the L2 is what holds the float32 kernel) and lists its
//            nonzero counts for place;
//   scan     one block: the tiles' entry starts, and the resolve's work
//            list. A tile of more than kCap entries is split into chunks of
//            kCap, which add their sums to the tile's float32 sums in the
//            scratch. Work items go heaviest first (split chunks, then
//            tiles by load);
//   place    each block reserves a range of each tile's list for the
//            counts that count listed, then puts each entry there, in no
//            fixed order: the point's index in its image and its cell's key
//            in the tile, so that the resolve sorts without reading the
//            points. It also zeroes the split tiles' sums;
//   resolve  2 blocks an SM, each claiming work items in turn. A block
//            sorts an item's entries by cell in shared memory (a counting
//            sort by the cell's parity class, then the cell). Each group
//            of 8 lanes (4 channels a lane) then walks a contiguous run of
//            them. It reads each entry's 128 B grad_out line once (__ldcs),
//            sums a whole cell's entries in registers, and adds the cell's
//            4 taps that fall inside the tile to a float32 tile in shared
//            memory. The classes go one after the other, and two cells of
//            one class share no texel. So a cell whose entries one group
//            holds alone is added with plain loads and stores, and a cell
//            cut between groups is added by the group that holds its last
//            piece, which adds the others' pieces once they have staged
//            them. Shared float atomics are compare-and-swap loops on this
//            card; with them the resolve took 3 times as long. Then the
//            tile is written once, as bf16 with 16-byte stores, zeros
//            included; a chunk of a split tile instead adds its nonzero
//            sums to the tile's in the scratch with float4 atomics;
//   merge    a split tile's sums, each rounded once.
// No zero-fill of the gradient, no float32 gradient in device memory (only
// the split tiles' sums), and no cast pass. The entries' order in a tile's
// list and the split tiles' atomics vary from run to run, so the sums are
// not bit-reproducible. ops/triplane.py bin_plain models the binning (the
// same tiles, counts and chunks).
//
// Extra bytes against the bound: an entry listed in 2 or 4 tiles reads its
// grad_out line once per tile (about 1/8 more at the coarse pass), the
// points are read 3 times (count, place and resolve), and the lists (4 B
// an entry) are written once and read twice. What holds it above the bound
// is latency, not bytes: a work item's sort and its 4 class walks each
// wait for memory, with 512 lines in flight an SM at most (PERF.md,
// section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// ops/triplane.py TILE and CAP name the same tile side and chunk cap
constexpr int kTile = 16;
constexpr int kCap = 4096;
constexpr int kC = 32;
constexpr int kLanes = kC / 4;              // a point's lanes, 4 channels each
constexpr int kGroups = kThreads / kLanes;  // entries walked at once
constexpr int kTexels = kTile * kTile;
constexpr int kTileVec = kTexels * kLanes;  // float4s of a float32 tile
constexpr int kUnits = kTexels * 4;         // 16-byte bf16 stores of a tile
constexpr int kAhead = 8;   // entries loaded ahead by a group
// the resolve's sort: a thread's entries of a work item
constexpr int kSortAhead = kCap / kThreads;
constexpr int kScanThreads = 1024;
// count and place: points a block, and the tiles (from the block's first
// image on) whose counts the block keeps in shared memory; any further
// tile's entries go to the global counts one by one
constexpr int kPointsPerBlock = 1024;
constexpr int kHist = 4096;
static_assert(kPointsPerBlock < 1 << 16 && kHist < 1 << 15,
              "count's lists pack a bin and its count in 32 bits");
static_assert(kCap % kThreads == 0, "the resolve's sort");
// resolve: a tile's cells, x0 and y0 from one before the tile to its last
// texel, in 4 parity classes of x0 and y0
constexpr int kSide = kTile + 1;
constexpr int kCells = kSide * kSide;
constexpr int kKeys = 4 * kCells;
// a list entry: the point's index in its image, then its cell's key
constexpr int kKeyBits = 11;
static_assert(kKeys <= 1 << kKeyBits, "cell keys");
constexpr int kResolveSmem =
    (kTileVec + kThreads * 4) * sizeof(float4) +
    (kCap + kKeys + 1 + kGroups + kThreads / 32) * sizeof(int);
// the scan's values a tile: entries, whether it is split, and the work
// items of each of kBuckets load buckets (heaviest first)
constexpr int kBuckets = 5;
constexpr int kValues = 2 + kBuckets;

// A point's cell on one plane and its bilinear weights, rounded as
// triplane_sample.cu cell_of and ops/triplane.py _cells round them.
struct Cell {
  int x0, y0;
  float wx1, wy1;
};

__device__ __forceinline__ float unnormalize(float g, int size) {
  return fminf(fmaxf(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.f), 0.5f * size),
                               0.5f), -2.f), size + 1.f);
}

__device__ __forceinline__ Cell cell_of(float gx, float gy, int H, int W) {
  const float ix = unnormalize(gx, W), iy = unnormalize(gy, H);
  const float fx0 = floorf(ix), fy0 = floorf(iy);
  return Cell{(int)fx0, (int)fy0, ix - fx0, iy - fy0};
}

// A cell's key in the resolve's sort: its parity class, then its place
// among the tile's cells.
__device__ __forceinline__ int cell_key(int x0, int y0, int x_lo, int y_lo) {
  return ((x0 & 1) | (y0 & 1) << 1) * kCells + (y0 - y_lo + 1) * kSide +
         x0 - x_lo + 1;
}

// The tiles that a cell's in-range taps touch: key j of 4 is the tile of
// (row j >> 1, column j & 1) of the up to 2 rows and 2 columns, -1 where
// there is none, and cell[j] the cell's key in that tile (cell_key). Tile
// (ty, tx) of plane image img is (img * TY + ty) * TX + tx.
__device__ __forceinline__ void cell_tiles(const Cell& c, int H, int W,
                                           int TX, int TY, int img,
                                           int key[4], int cell[4]) {
  const int ca = (c.x0 >= 0 && c.x0 < W) ? c.x0 / kTile : -1;
  int cb = (c.x0 + 1 >= 0 && c.x0 + 1 < W) ? (c.x0 + 1) / kTile : -1;
  const int ra = (c.y0 >= 0 && c.y0 < H) ? c.y0 / kTile : -1;
  int rb = (c.y0 + 1 >= 0 && c.y0 + 1 < H) ? (c.y0 + 1) / kTile : -1;
  if (cb == ca) cb = -1;
  if (rb == ra) rb = -1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = (j >> 1) ? rb : ra, col = (j & 1) ? cb : ca;
    key[j] = (r >= 0 && col >= 0) ? (img * TY + r) * TX + col : -1;
    cell[j] = cell_key(c.x0, c.y0, col * kTile, r * kTile);
  }
}

// The run of consecutive lanes of the warp with the same key k as this
// lane: its first lane and its length. Every lane of the warp calls it.
struct Run {
  int head, len;
};

__device__ __forceinline__ Run run_of(int k) {
  const int lane = threadIdx.x & 31;
  const unsigned upto = 0xffffffffu >> (31 - lane);  // lanes 0..lane
  const int prev = __shfl_up_sync(0xffffffffu, k, 1);
  const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || k != prev);
  const int head = 31 - __clz(heads & upto);
  const unsigned after = heads & ~upto;
  return Run{head, (after ? __ffs(after) - 1 : 32) - head};
}

// Calls f(k, entry, head, len) on every lane of the block for every point
// of the block and each of its 4 tile keys k a plane (-1 for none, and for
// a lane past the last point), where entry is the point's list entry in
// that tile (its index m in its image, then its cell's key: m << kKeyBits
// | key), head the first lane of the run of consecutive lanes with the
// same key and len that run's length. A key slot that no lane of the warp
// uses is skipped.
template <class F>
__device__ __forceinline__ void for_each_key(const float* __restrict__ coords,
                                             int first, int points, int M,
                                             int H, int W, int TX, int TY,
                                             float scale, F&& f) {
  constexpr int kPer = kPointsPerBlock / kThreads;
  // the thread's points' coordinates, all loaded before any is used
  float xyz[kPer][3];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = first + r * kThreads + threadIdx.x;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      xyz[r][a] = i < points ? __fmul_rn(scale, __ldg(coords + 3 * i + a))
                             : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = first + r * kThreads + threadIdx.x;
    const bool live = i < points;
    const int n = live ? i / M : 0;
    const float x = xyz[r][0], y = xyz[r][1], z = xyz[r][2];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      // plane 0 samples (x, y), plane 1 (x, z), plane 2 (z, y)
      const Cell c = cell_of(p == 2 ? z : x, p == 1 ? z : y, H, W);
      int key[4], cell[4];
      cell_tiles(c, H, W, TX, TY, n * 3 + p, key, cell);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = live ? key[j] : -1;
        if (!__any_sync(0xffffffffu, k >= 0)) continue;
        const Run run = run_of(k);
        f(k, (unsigned)(i - n * M) << kKeyBits | cell[j], run.head, run.len);
      }
    }
  }
}

// count: add each tile's entries to counts, and list the block's nonzero
// counts for place (row blockIdx.x of lists: their number, then each as
// bin << 16 | count; a block has at most kPointsPerBlock entries a tile).
__global__ void __launch_bounds__(kThreads)
bwd_bin_count_kernel(const float* __restrict__ coords,
                     int* __restrict__ counts, int* __restrict__ lists,
                     int points, int M, int H, int W, int TX, int TY,
                     float scale) {
  __shared__ int hist[kHist];
  __shared__ int listed;
  const int first = blockIdx.x * kPointsPerBlock;
  const int tile0 = first / M * 3 * TY * TX;
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x; b < kHist; b += kThreads) hist[b] = 0;
  if (threadIdx.x == 0) listed = 0;
  __syncthreads();
  for_each_key(coords, first, points, M, H, W, TX, TY, scale,
               [&](int k, unsigned, int head, int len) {
                 if (k < 0 || lane != head) return;
                 if (k - tile0 < kHist)
                   atomicAdd(hist + k - tile0, len);
                 else
                   atomicAdd(counts + k, len);
               });
  __syncthreads();
  int* list = lists + blockIdx.x * (kHist + 1);
  for (int b = threadIdx.x; b < kHist; b += kThreads) {
    if (!hist[b]) continue;
    atomicAdd(counts + tile0 + b, hist[b]);
    list[1 + atomicAdd(&listed, 1)] = b << 16 | hist[b];
  }
  __syncthreads();
  if (threadIdx.x == 0) list[0] = listed;
}

// place: counts holds each tile's next free slot; the block reserves a
// range for its entries of each tile that count listed, and puts each
// entry there: the point's index in its image and its cell's key in the
// tile. It also zeroes the split tiles' sums.
__global__ void __launch_bounds__(kThreads)
bwd_bin_place_kernel(const float* __restrict__ coords,
                     int* __restrict__ cursors, const int* __restrict__ lists,
                     unsigned* __restrict__ bins,
                     const int* __restrict__ n_split,
                     float4* __restrict__ scratch, int points, int M, int H,
                     int W, int TX, int TY, float scale) {
  __shared__ int hist[kHist];
  __shared__ int base[kHist];
  // zero the split tiles' float32 sums, which the resolve adds to
  for (int s = blockIdx.x * kThreads + threadIdx.x; s < *n_split * kTileVec;
       s += gridDim.x * kThreads)
    scratch[s] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int first = blockIdx.x * kPointsPerBlock;
  const int tile0 = first / M * 3 * TY * TX;
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x; b < kHist; b += kThreads) hist[b] = 0;
  const int* list = lists + blockIdx.x * (kHist + 1);
  for (int j = threadIdx.x; j < list[0]; j += kThreads) {
    const int b = list[1 + j] >> 16;
    base[b] = atomicAdd(cursors + tile0 + b, list[1 + j] & 0xffff);
  }
  __syncthreads();
  for_each_key(coords, first, points, M, H, W, TX, TY, scale,
               [&](int k, unsigned entry, int head, int len) {
                 const bool local = k - tile0 < kHist;
                 int at = 0;
                 if (k >= 0 && lane == head)
                   at = local ? base[k - tile0] + atomicAdd(hist + k - tile0,
                                                            len)
                              : atomicAdd(cursors + k, len);
                 at = __shfl_sync(0xffffffffu, at, head);
                 if (k >= 0) bins[at + lane - head] = entry;
               });
}

// The workspace of int32 words (ops/triplane.py _workspace_ints mirrors its
// size; chip_smoke.py reads n_work, n_split and starts):
//   [0] n_work, [1] n_split, [2, T + 3) starts, [T + 3, 2T + 3) counts
//   (then the place cursors), [2T + 3, 3T + 3) slot (a split tile's place
//   in the split list and the scratch, else -1), [3T + 3, 4T + 3) the split
//   tiles, [4T + 3] the resolve's next work item, [4T + 4, ...) the work
//   items (tile, chunk) as int2.
struct Workspace {
  int* totals;
  int* starts;
  int* counts;
  int* slot;
  int* splits;
  int* next;
  int2* work;
  __host__ __device__ Workspace(int* ws, int T)
      : totals(ws), starts(ws + 2), counts(ws + T + 3), slot(ws + 2 * T + 3),
        splits(ws + 3 * T + 3), next(ws + 4 * T + 3),
        work(reinterpret_cast<int2*>(ws + 4 * T + 4)) {
  }
};

__device__ __forceinline__ int chunks_of(int c) {
  return c > kCap ? (c + kCap - 1) / kCap : 1;
}

__device__ __forceinline__ int bucket_of(int c) {
  return c > kCap ? 0 : c > kCap / 2 ? 1 : c > kCap / 16 ? 2 : c > 0 ? 3 : 4;
}

__device__ __forceinline__ void tile_values(int c, int v[kValues]) {
  const int k = chunks_of(c), b = bucket_of(c);
  v[0] = c;
  v[1] = c > kCap ? 1 : 0;
#pragma unroll
  for (int j = 0; j < kBuckets; ++j) v[2 + j] = j == b ? k : 0;
}

// One block: exclusive scans over the tiles of tile_values, then the
// starts, cursors, split slots, split list and work list.
__global__ void __launch_bounds__(kScanThreads)
bwd_bin_scan_kernel(int* __restrict__ ws, int T) {
  Workspace w(ws, T);
  __shared__ int warp_sums[kScanThreads / 32][kValues];
  const int per = (T + kScanThreads - 1) / kScanThreads;
  const int lo = min((int)threadIdx.x * per, T), hi = min(lo + per, T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int run[kValues] = {};
  for (int t = lo; t < hi; ++t) {
    int v[kValues];
    tile_values(w.counts[t], v);
#pragma unroll
    for (int j = 0; j < kValues; ++j) run[j] += v[j];
  }
  // inclusive scan of the threads' sums within each warp, then across the
  // warps' totals
  int incl[kValues];
#pragma unroll
  for (int j = 0; j < kValues; ++j) {
    incl[j] = run[j];
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl[j], off);
      if (lane >= off) incl[j] += up;
    }
    if (lane == 31) warp_sums[warp][j] = incl[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < kValues; ++j) {
      int s = warp_sums[lane][j];
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += up;
      }
      warp_sums[lane][j] = s;  // inclusive over the warps
    }
  }
  __syncthreads();
  int before[kValues], total[kValues];
#pragma unroll
  for (int j = 0; j < kValues; ++j) {
    before[j] = incl[j] - run[j] + (warp > 0 ? warp_sums[warp - 1][j] : 0);
    total[j] = warp_sums[kScanThreads / 32 - 1][j];
  }
  // the work list's buckets one after the other, heaviest first
  int base[kBuckets];
  base[0] = 0;
#pragma unroll
  for (int j = 1; j < kBuckets; ++j) base[j] = base[j - 1] + total[1 + j];
  // a thread rewrites only the counts of its own tiles
  for (int t = lo; t < hi; ++t) {
    const int c = w.counts[t];
    int v[kValues];
    tile_values(c, v);
    w.starts[t] = before[0];
    w.counts[t] = before[0];
    w.slot[t] = c > kCap ? before[1] : -1;
    if (c > kCap) w.splits[before[1]] = t;
    const int b = bucket_of(c);
    int at = 0;
#pragma unroll
    for (int j = 0; j < kBuckets; ++j)
      if (j == b) at = base[j] + before[2 + j];
    for (int k = 0; k < chunks_of(c); ++k) w.work[at + k] = make_int2(t, k);
#pragma unroll
    for (int j = 0; j < kValues; ++j) before[j] += v[j];
  }
  if (threadIdx.x == 0) {
    w.starts[T] = total[0];
    int n_work = 0;
#pragma unroll
    for (int j = 0; j < kBuckets; ++j) n_work += total[2 + j];
    w.totals[0] = n_work;
    w.totals[1] = total[1];
    *w.next = 0;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  // round to nearest even; a in the low half (the lower channel)
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 to_bf16(float4 a, float4 b) {
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                    pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

// Exclusive scan of a[0, n) in place, by the whole block; a[n] gets the
// total. warp_sums holds kThreads / 32 ints.
__device__ void block_exclusive_scan(int* a, int n, int* warp_sums) {
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min((int)threadIdx.x * per, n), hi = min(lo + per, n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int sum = 0;
  for (int e = lo; e < hi; ++e) sum += a[e];
  int incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = incl - sum;
  for (int v = 0; v < warp; ++v) before += warp_sums[v];
  for (int e = lo; e < hi; ++e) {
    const int c = a[e];
    a[e] = before;
    before += c;
  }
  if (threadIdx.x == kThreads - 1) a[n] = before;
  __syncthreads();
}

// A cell's 4 taps' sums of 4 channels (a lane's share).
struct Taps {
  float4 v[4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void add(const Taps& o) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q].x += o.v[q].x;
      v[q].y += o.v[q].y;
      v[q].z += o.v[q].z;
      v[q].w += o.v[q].w;
    }
  }
};

__global__ void __launch_bounds__(kThreads, 2)
bwd_bin_resolve_kernel(const float4* __restrict__ grad_out,
                       const float* __restrict__ coords,
                       const unsigned* __restrict__ bins, const int* ws, int T,
                       uint4* __restrict__ grad_planes,
                       float4* __restrict__ scratch, int M, int H, int W,
                       int TX, int TY, float scale) {
  extern __shared__ float4 smem[];
  float4* tile = smem;
  // each group's piece of a cell that it shares with the next group
  Taps* staged = reinterpret_cast<Taps*>(tile + kTileVec);  // [group][lane]
  int* sorted = reinterpret_cast<int*>(staged + kThreads);  // kCap entries
  int* keys = sorted + kCap;              // kKeys + 1: starts, then ends
  int* staged_key = keys + kKeys + 1;     // kGroups
  int* warp_sums = staged_key + kGroups;  // kThreads / 32
  const Workspace w(const_cast<int*>(ws), T);
  __shared__ int claimed;
  const int lane32 = threadIdx.x & 31;
  const int group = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  // work items, heaviest first, claimed one at a time until none is left
  for (;;) {
    if (threadIdx.x == 0) claimed = atomicAdd(w.next, 1);
    __syncthreads();
    const int at_item = claimed;
    if (at_item >= w.totals[0]) return;
    const int2 item = w.work[at_item];
    const int t = item.x;
    const int img = t / (TY * TX);
    const int ty = t / TX - img * TY, tx = t % TX;
    const int n = img / 3, p = img - 3 * n;
    const int x_lo = tx * kTile, y_lo = ty * kTile;
    const int e0 = w.starts[t] + item.y * kCap;
    const int count = min(e0 + kCap, w.starts[t + 1]) - e0;
    const int ax = (p == 2) ? 2 : 0, ay = (p == 1) ? 2 : 1;
    const float* c_img = coords + (size_t)n * M * 3;
    if (count == 0) {
      // an empty tile (never a chunk of a split one): its zeros
      for (int s = threadIdx.x; s < kUnits; s += kThreads) {
        const int texel = s >> 2;
        const int xi = x_lo + (texel % kTile), yi = y_lo + texel / kTile;
        if (xi < W && yi < H)
          grad_planes[((size_t)(img * H + yi) * W + xi) * 4 + (s & 3)] =
              make_uint4(0u, 0u, 0u, 0u);
      }
      __syncthreads();
      continue;
    }

    // the item's entries, kSortAhead a thread, loaded before the zeroing
    unsigned v[kSortAhead];
#pragma unroll
    for (int u = 0; u < kSortAhead; ++u) {
      const int e = u * kThreads + threadIdx.x;
      v[u] = e < count ? __ldg(bins + e0 + e) : 0u;
    }
    for (int s = threadIdx.x; s < kTileVec; s += kThreads)
      tile[s] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = threadIdx.x; s <= kKeys; s += kThreads) keys[s] = 0;
    __syncthreads();
    // the counting sort of the entries by key, a run of a warp's lanes with
    // one key taking one atomic
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int u = 0; u < kSortAhead; ++u) {
        if (u * kThreads >= count) break;
        const bool live = u * kThreads + (int)threadIdx.x < count;
        const int k = live ? (int)(v[u] & ((1u << kKeyBits) - 1)) : -1;
        const Run run = run_of(k);
        int at = 0;
        if (k >= 0 && lane32 == run.head) at = atomicAdd(keys + k, run.len);
        if (pass == 1) {
          at = __shfl_sync(0xffffffffu, at, run.head);
          if (k >= 0) sorted[at + lane32 - run.head] = v[u] >> kKeyBits;
        }
      }
      __syncthreads();
      if (pass == 0) block_exclusive_scan(keys, kKeys, warp_sums);
    }
    // keys[k] is now the end of key k's entries in sorted, the start of
    // key k + 1's

    const float4* g_img = grad_out + (size_t)img * M * kLanes + lane;
    float4* tile_lane = tile + lane;
    // a cell's taps that fall inside the tile, added with plain loads and
    // stores: no other group adds to them while this one does
    auto add_to_tile = [&](int cx, int cy, const Taps& a) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int xi = cx + (q & 1), yi = cy + (q >> 1);
        const int lx = xi - x_lo, ly = yi - y_lo;
        if (lx < 0 || lx >= kTile || ly < 0 || ly >= kTile || xi >= W ||
            yi >= H)
          continue;
        float4* texel = tile_lane + (ly * kTile + lx) * kLanes;
        float4 v = *texel;
        v.x += a.v[q].x;
        v.y += a.v[q].y;
        v.z += a.v[q].z;
        v.w += a.v[q].w;
        *texel = v;
      }
    };
    for (int cls = 0; cls < 4; ++cls) {
      // the class's entries, cut evenly over the groups; a cell cut
      // between groups is added once, by the group that holds its last
      // piece, after the others have staged theirs
      const int lo = cls ? keys[cls * kCells - 1] : 0;
      const int hi = keys[cls * kCells + kCells - 1];
      if (lo == hi) continue;  // the same for every thread
      const int per = (hi - lo + kGroups - 1) / kGroups;
      const int first = min(lo + group * per, hi), last = min(first + per, hi);
      if (lane == 0) staged_key[group] = -1;
      int cx = 0, cy = 0, held_key = -1, hx = 0, hy = 0;
      bool open = false;
      Taps acc;
      auto close = [&](bool at_end) {
        const int k = cell_key(cx, cy, x_lo, y_lo);
        if (at_end && keys[k] > last) {
          // cut at this group's end: stage it (a middle piece included)
          staged[group * kLanes + lane] = acc;
          if (lane == 0) staged_key[group] = k;
          return;
        }
        // the last piece of a cell cut at this group's start goes in now:
        // the groups that hold its other pieces stage them
        if ((k ? keys[k - 1] : 0) < first) held_key = k, hx = cx, hy = cy;
        add_to_tile(cx, cy, acc);
      };
      for (int base = first; base < last; base += kAhead) {
        int m[kAhead];
        float4 g[kAhead];
        float gx[kAhead], gy[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          m[u] = base + u < last ? sorted[base + u] : -1;
          if (m[u] >= 0) {
            g[u] = __ldcs(g_img + m[u] * kLanes);
            gx[u] = __ldg(c_img + 3 * m[u] + ax);
            gy[u] = __ldg(c_img + 3 * m[u] + ay);
          }
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (m[u] < 0) break;
          const Cell c = cell_of(__fmul_rn(scale, gx[u]),
                                 __fmul_rn(scale, gy[u]), H, W);
          if (!open || c.x0 != cx || c.y0 != cy) {
            if (open) close(false);
            open = true, cx = c.x0, cy = c.y0;
            acc.zero();
          }
          const float wx0 = 1.f - c.wx1, wy0 = 1.f - c.wy1;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float wq =
                ((q >> 1) ? c.wy1 : wy0) * ((q & 1) ? c.wx1 : wx0);
            acc.v[q].x += wq * g[u].x;
            acc.v[q].y += wq * g[u].y;
            acc.v[q].z += wq * g[u].z;
            acc.v[q].w += wq * g[u].w;
          }
        }
      }
      if (open) close(true);
      __syncthreads();
      if (held_key >= 0) {
        // the staged pieces of this cell are those of the groups just
        // before this one
        Taps more;
        more.zero();
        for (int b = group - 1; b >= 0 && staged_key[b] == held_key; --b)
          more.add(staged[b * kLanes + lane]);
        add_to_tile(hx, hy, more);
      }
      __syncthreads();
    }

    const int slot = w.slot[t];
    if (slot >= 0) {
      // a chunk of a split tile: add its sums to the tile's in the scratch
      float4* sums = scratch + (size_t)slot * kTileVec;
      for (int s = threadIdx.x; s < kTileVec; s += kThreads) {
        const float4 v = tile[s];
        if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
          atomicAdd(sums + s, v);
      }
    } else {
      for (int s = threadIdx.x; s < kUnits; s += kThreads) {
        const int texel = s >> 2, q = s & 3;
        const int xi = x_lo + (texel % kTile), yi = y_lo + texel / kTile;
        if (xi >= W || yi >= H) continue;
        grad_planes[((size_t)(img * H + yi) * W + xi) * 4 + q] = to_bf16(
            tile[texel * kLanes + 2 * q], tile[texel * kLanes + 2 * q + 1]);
      }
    }
    __syncthreads();
  }
}

// A block per (split tile, quarter of its store units) in turn: the
// tile's sums rounded once.
constexpr int kMergeParts = kUnits / kThreads;

__global__ void __launch_bounds__(kThreads)
bwd_bin_merge_kernel(const int* ws, int T, const float4* __restrict__ scratch,
                     uint4* __restrict__ grad_planes, int H, int W, int TX,
                     int TY) {
  const Workspace w(const_cast<int*>(ws), T);
  for (int b = blockIdx.x; b < w.totals[1] * kMergeParts; b += gridDim.x) {
    const int split = b / kMergeParts;
    const int t = w.splits[split];
    const int img = t / (TY * TX);
    const int ty = t / TX - img * TY, tx = t % TX;
    const int s = (b % kMergeParts) * kThreads + threadIdx.x;
    const int texel = s >> 2, q = s & 3;
    const int xi = tx * kTile + texel % kTile,
              yi = ty * kTile + texel / kTile;
    if (xi >= W || yi >= H) continue;
    const float4* sums = scratch + (size_t)split * kTileVec + texel * kLanes;
    grad_planes[((size_t)(img * H + yi) * W + xi) * 4 + q] =
        to_bf16(__ldcg(sums + 2 * q), __ldcg(sums + 2 * q + 1));
  }
}

}  // namespace

// grad_out (n, 3, m, 32) float32, coords (n, m, 3) float32 -> grad_planes
// (n, 3, h, w, 32) bf16, every element written. ws: the int32 workspace
// above, with room for `items` work items; lists: count's lists, kHist + 1
// int32 a block of kPointsPerBlock points; bins: 12 n m uint32 (m below
// 2^21); scratch:
// `slots` float32 tiles (kTile^2 x 32). items and slots are at least the
// work items and split tiles that any input of this size can make
// (ops/triplane.py work_bounds). The wrapper checks the types, contiguity,
// 16-byte alignment and that every index fits in 32 bits.
extern "C" int triplane_backward_binned(const void* grad_out,
                                        const void* coords, void* grad_planes,
                                        void* ws, void* lists, void* bins,
                                        void* scratch,
                                        int n, int m, int h, int w, int c,
                                        int items, int slots, float scale,
                                        void* stream) {
  if (c != kC) return (int)cudaErrorInvalidValue;
  const int TX = (w + kTile - 1) / kTile, TY = (h + kTile - 1) / kTile;
  const int T = n * 3 * TX * TY;
  if (T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const Workspace space((int*)ws, T);
  cudaMemsetAsync(space.counts, 0, sizeof(int) * T, s);
  const int points = n * m;
  const int blocks = (points + kPointsPerBlock - 1) / kPointsPerBlock;
  if (points > 0)
    bwd_bin_count_kernel<<<blocks, kThreads, 0, s>>>(
        (const float*)coords, space.counts, (int*)lists, points, m, h, w, TX,
        TY, scale);
  bwd_bin_scan_kernel<<<1, kScanThreads, 0, s>>>((int*)ws, T);
  if (points > 0)
    bwd_bin_place_kernel<<<blocks, kThreads, 0, s>>>(
        (const float*)coords, space.counts, (const int*)lists,
        (unsigned*)bins, space.totals + 1,
        (float4*)scratch, points, m, h, w, TX, TY, scale);
  cudaFuncSetAttribute(bwd_bin_resolve_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kResolveSmem);
  // as many resolve blocks as the card holds at once (2 an SM), each
  // claiming work items until none is left
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  bwd_bin_resolve_kernel<<<min(items, 2 * sms), kThreads, kResolveSmem, s>>>(
      (const float4*)grad_out, (const float*)coords, (const unsigned*)bins,
      (const int*)ws, T, (uint4*)grad_planes, (float4*)scratch, m, h, w, TX,
      TY, scale);
  if (slots > 0)
    bwd_bin_merge_kernel<<<min(slots * kMergeParts, 8 * sms), kThreads, 0,
                           s>>>(
        (const int*)ws, T, (const float4*)scratch, (uint4*)grad_planes, h, w,
        TX, TY);
  return (int)cudaGetLastError();
}

extern "C" const char* triplane_backward_binned_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
