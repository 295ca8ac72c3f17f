// The binned rasterizers' prep on Hopper (sm_90a): K1, K2 and K3.
//
// Replaces, for CUDA tensors, the torch prep next3d_tpu_torch/ops/raster.py
// binned_prep, which stands for the TPU prep
// next3d_tpu/ops/pallas_raster.py _binned_uv_entries (32-px tiles),
// _binned_uv_entries16 (16-px tiles) and _binned_prep. Its output contract
// is binned_prep's: the slab (B, K, E) float32 of the K coefficient rows
// (b0 b1 b2 z, with u v when there is a payload, each (c, x, y), then the
// face id: K = 19 or 13) of the E = 4F (32 px) or 9F (16 px) tile entries,
// grouped by tile, and starts (B, T + 1) int32, the segment bounds.
//
// Two launches after a memset of the tile counters:
//   count   one thread per (image, face): the face's pixel coordinates,
//           area and keep flag, its 4 (bbox corners) or 9 (3x3 rule) tile
//           entries, counted per tile in shared memory, then added to the
//           image's global counts;
//   place   one thread per (image, face) again: every block scans its
//           image's counts into the segment starts (block 0 writes them),
//           then each thread computes the face's coefficient rows and puts
//           them at the next free slot of each of its tiles' segments,
//           taken with an atomicAdd.
// A face's rows are recomputed in place rather than kept from count: the
// arithmetic is cheaper than a (B, F, K) round trip through device memory.
//
// Exactness: the resolve kernels and their plain versions are held bit for
// bit against each other, and the plain versions keep the torch prep. So
// every coefficient rounds as torch's separate elementwise launches do:
// each step with __fadd_rn / __fsub_rn / __fmul_rn / __frcp_rn, which nvcc
// never contracts into an FMA, in the operation order of binned_prep, with
// the z, u and v rows computed from the edge coefficient b0c before it is
// set to -inf for a dropped face.
//
// Segment order: the atomics place a segment's entries in no fixed order,
// and the order changes from run to run. The outputs do not depend on it:
// the resolve takes per pixel the lexicographic minimum of (z, face id)
// among the candidates that cover it, and a face has at most one entry per
// tile (its duplicate corners go to the dummy tile T), so that minimum
// names one candidate whatever the order. Entries of the dummy tile are
// not written: nothing reads the slab past starts[:, T].
//
// What bounds it: launch overhead and latency, not bytes or operations.
// The work is about 10k faces an image (a few hundred float operations
// each) and the rows of the entries that are not dummies (about 6k an
// image for the FLAME-sized head at 256^2 and 32-px tiles, 76 B each with
// (u, v)).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// A face's corners in pixels, its keep flag and its tile entries (T for
// the dummy tile), as binned_prep computes them.
template <int kTile>
struct Face {
  static constexpr int kEntries = kTile == 32 ? 4 : 9;
  float x[3], y[3], z[3];
  float area;
  bool keep;
  int tile[kEntries];
};

__device__ __forceinline__ float to_pixel(float v, float half) {
  // (v + 1) * (S / 2) - 0.5
  return __fsub_rn(__fmul_rn(__fadd_rn(v, 1.f), half), 0.5f);
}

__device__ __forceinline__ int tile_of(float v, int n, float tile) {
  // clamp(floor(v / tile), 0, n - 1); tile is a power of two, so the
  // division is exact
  return (int)fminf(fmaxf(floorf(v / tile), 0.f), (float)(n - 1));
}

template <int kTile>
__device__ Face<kTile> face_setup(const float* __restrict__ verts,
                                  const int64_t* __restrict__ faces, int b,
                                  int f, int num_verts, int size) {
  Face<kTile> fc;
  const float half = 0.5f * size;
  const float* vb = verts + (int64_t)b * num_verts * 3;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* v = vb + faces[3 * f + i] * 3;
    fc.x[i] = to_pixel(v[0], half);
    fc.y[i] = to_pixel(v[1], half);
    fc.z[i] = v[2];
  }
  // (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
  fc.area = __fsub_rn(
      __fmul_rn(__fsub_rn(fc.x[1], fc.x[0]), __fsub_rn(fc.y[2], fc.y[0])),
      __fmul_rn(__fsub_rn(fc.y[1], fc.y[0]), __fsub_rn(fc.x[2], fc.x[0])));
  fc.keep = fc.area > 1e-8f;

  const int n = size / kTile;  // tiles a side
  const int T = n * n;
  const float ft = (float)kTile;
  const int txlo = tile_of(fminf(fminf(fc.x[0], fc.x[1]), fc.x[2]), n, ft);
  const int txhi = tile_of(fmaxf(fmaxf(fc.x[0], fc.x[1]), fc.x[2]), n, ft);
  const int tylo = tile_of(fminf(fminf(fc.y[0], fc.y[1]), fc.y[2]), n, ft);
  const int tyhi = tile_of(fmaxf(fmaxf(fc.y[0], fc.y[1]), fc.y[2]), n, ft);
  if constexpr (kTile == 32) {
    // the 4 bbox-corner tiles, duplicates routed to the dummy tile T
    fc.tile[0] = tylo * n + txlo;
    fc.tile[1] = txhi > txlo ? tylo * n + txhi : T;
    fc.tile[2] = tyhi > tylo ? tyhi * n + txlo : T;
    fc.tile[3] = (txhi > txlo && tyhi > tylo) ? tyhi * n + txhi : T;
  } else {
    // the 3x3 tile rectangle from the bbox-min tile, cut to the bbox
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        fc.tile[dy * 3 + dx] = (txlo + dx <= txhi && tylo + dy <= tyhi)
            ? (tylo + dy) * n + txlo + dx : T;
  }
  if (!fc.keep) {
#pragma unroll
    for (int j = 0; j < Face<kTile>::kEntries; ++j) fc.tile[j] = T;
  }
  return fc;
}

// Exclusive scan of counts[0, T) into starts[0, T] in shared memory, by
// the whole block.
__device__ void block_starts(const int* __restrict__ counts, int T,
                             int* starts, int* partial) {
  const int per = (T + kThreads) / kThreads;  // ceil((T + 1) / kThreads)
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, T + 1);
  int sum = 0;
  for (int i = lo; i < min(hi, T); ++i) sum += counts[i];
  partial[threadIdx.x] = sum;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const int add = threadIdx.x >= off ? partial[threadIdx.x - off] : 0;
    __syncthreads();
    partial[threadIdx.x] += add;
    __syncthreads();
  }
  int run = partial[threadIdx.x] - sum;
  for (int i = lo; i < hi; ++i) {
    starts[i] = run;
    if (i < T) run += counts[i];
  }
  __syncthreads();
}

template <int kTile>
__global__ void __launch_bounds__(kThreads)
count_kernel(const float* __restrict__ verts,
             const int64_t* __restrict__ faces,
             int* __restrict__ counts,  // (B, T + 1), zeroed
             int num_verts, int num_faces, int size) {
  extern __shared__ int hist[];  // T
  const int n = size / kTile;
  const int T = n * n;
  const int b = blockIdx.y;
  const int f = blockIdx.x * kThreads + threadIdx.x;
  for (int i = threadIdx.x; i < T; i += kThreads) hist[i] = 0;
  __syncthreads();
  if (f < num_faces) {
    const Face<kTile> fc =
        face_setup<kTile>(verts, faces, b, f, num_verts, size);
#pragma unroll
    for (int j = 0; j < Face<kTile>::kEntries; ++j)
      if (fc.tile[j] < T) atomicAdd(&hist[fc.tile[j]], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < T; i += kThreads)
    if (hist[i]) atomicAdd(&counts[b * (T + 1) + i], hist[i]);
}

__device__ __forceinline__ void edge(float xa, float ya, float xb, float yb,
                                     float inv, float* c, float* gx,
                                     float* gy) {
  // ((yb - ya) * xa - (xb - xa) * ya) * inv, -(yb - ya) * inv,
  // (xb - xa) * inv
  const float dy = __fsub_rn(yb, ya), dx = __fsub_rn(xb, xa);
  *c = __fmul_rn(__fsub_rn(__fmul_rn(dy, xa), __fmul_rn(dx, ya)), inv);
  *gx = __fmul_rn(-dy, inv);
  *gy = __fmul_rn(dx, inv);
}

// The (c, x, y) rows of the affine form of corner values a0, a1, a2 from
// the edge rows b: (b0 * a0 + b1 * a1) + b2 * a2 for each of c, x, y.
__device__ __forceinline__ void affine(const float* b, float a0, float a1,
                                       float a2, float* out) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    out[k] = __fadd_rn(__fadd_rn(__fmul_rn(b[k], a0), __fmul_rn(b[3 + k], a1)),
                       __fmul_rn(b[6 + k], a2));
}

template <int kTile, bool kUV>
__global__ void __launch_bounds__(kThreads)
place_kernel(const float* __restrict__ verts,
             const int64_t* __restrict__ faces,
             const float* __restrict__ attrs,  // (A, F, 3, 2) or null
             int attrs_batched, const int* __restrict__ counts,
             int* __restrict__ fill,          // (B, T + 1), zeroed
             float* __restrict__ slab,        // (B, K, E)
             int* __restrict__ starts_out,    // (B, T + 1)
             int num_verts, int num_faces, int size) {
  constexpr int kCoeffs = kUV ? 19 : 13;
  constexpr int kEntries = Face<kTile>::kEntries;
  extern __shared__ int smem[];
  int* starts = smem;                     // T + 1
  const int n = size / kTile;
  const int T = n * n;
  int* partial = smem + T + 1;            // kThreads
  const int b = blockIdx.y;
  block_starts(counts + b * (T + 1), T, starts, partial);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i <= T; i += kThreads)
      starts_out[b * (T + 1) + i] = starts[i];

  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= num_faces) return;
  const Face<kTile> fc =
      face_setup<kTile>(verts, faces, b, f, num_verts, size);

  float row[kCoeffs];
  // torch.where(keep, 1.0 / torch.where(keep, area, 1), 0), where
  // 1.0 / x is torch's reciprocal(x) * 1.0
  const float inv = fc.keep ? __frcp_rn(fc.area) : 0.f;
  edge(fc.x[1], fc.y[1], fc.x[2], fc.y[2], inv, &row[0], &row[1], &row[2]);
  edge(fc.x[2], fc.y[2], fc.x[0], fc.y[0], inv, &row[3], &row[4], &row[5]);
  edge(fc.x[0], fc.y[0], fc.x[1], fc.y[1], inv, &row[6], &row[7], &row[8]);
  affine(row, fc.z[0], fc.z[1], fc.z[2], &row[9]);
  if constexpr (kUV) {
    const float* a = attrs
        + ((int64_t)(attrs_batched ? b : 0) * num_faces + f) * 6;
    affine(row, a[0], a[2], a[4], &row[12]);  // u of corners 0, 1, 2
    affine(row, a[1], a[3], a[5], &row[15]);  // v
  }
  if (!fc.keep) row[0] = -__int_as_float(0x7f800000);  // -inf
  row[kCoeffs - 1] = (float)f;

  const int E = kEntries * num_faces;
  float* out = slab + (int64_t)b * kCoeffs * E;
  int* fb = fill + b * (T + 1);
#pragma unroll
  for (int j = 0; j < kEntries; ++j) {
    const int t = fc.tile[j];
    if (t >= T) continue;
    const int pos = starts[t] + atomicAdd(&fb[t], 1);
#pragma unroll
    for (int k = 0; k < kCoeffs; ++k) out[(int64_t)k * E + pos] = row[k];
  }
}

template <int kTile, bool kUV>
int prep(const float* verts, const int64_t* faces, const float* attrs,
         int attrs_batched, float* slab, int* starts, int* scratch,
         int batch, int num_verts, int num_faces, int size,
         cudaStream_t stream) {
  const int n = size / kTile;
  const int T = n * n;
  int* counts = scratch;
  int* fill = scratch + batch * (T + 1);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(int) * 2 * batch * (T + 1), stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((num_faces + kThreads - 1) / kThreads, batch);
  count_kernel<kTile><<<grid, kThreads, sizeof(int) * T, stream>>>(
      verts, faces, counts, num_verts, num_faces, size);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  place_kernel<kTile, kUV>
      <<<grid, kThreads, sizeof(int) * (T + 1 + kThreads), stream>>>(
          verts, faces, attrs, attrs_batched, counts, fill, slab, starts,
          num_verts, num_faces, size);
  return (int)cudaGetLastError();
}

}  // namespace

// verts (B, V, 3) float32, faces (F, 3) int64, attrs (1 or B, F, 3, 2)
// float32 or null (no payload: 13 rows, tile 32 only), slab (B, K, E),
// starts (B, T + 1) int32, scratch 2 * B * (T + 1) int32; size a multiple
// of tile (32 or 16). The wrapper checks shapes and types.
extern "C" int raster_binned_prep(const void* verts, const void* faces,
                                  const void* attrs, int attrs_batched,
                                  void* slab, void* starts, void* scratch,
                                  int batch, int num_verts, int num_faces,
                                  int size, int tile, void* stream) {
  if (batch == 0 || num_faces == 0) {
    return (int)cudaMemsetAsync(
        starts, 0, sizeof(int) * batch * ((size / tile) * (size / tile) + 1),
        (cudaStream_t)stream);
  }
  auto* v = (const float*)verts;
  auto* f = (const int64_t*)faces;
  auto* a = (const float*)attrs;
  auto* s = (float*)slab;
  auto* st = (int*)starts;
  auto* sc = (int*)scratch;
  auto cs = (cudaStream_t)stream;
  if (tile == 32 && attrs)
    return prep<32, true>(v, f, a, attrs_batched, s, st, sc, batch,
                          num_verts, num_faces, size, cs);
  if (tile == 32)
    return prep<32, false>(v, f, a, attrs_batched, s, st, sc, batch,
                           num_verts, num_faces, size, cs);
  if (tile == 16 && attrs)
    return prep<16, true>(v, f, a, attrs_batched, s, st, sc, batch,
                          num_verts, num_faces, size, cs);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* raster_binned_prep_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
