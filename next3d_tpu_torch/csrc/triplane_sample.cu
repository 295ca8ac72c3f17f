// Tri-plane bilinear sampling for Hopper (sm_90a), and its backward with
// respect to the planes.
//
// Replaces the TPU kernel next3d_tpu/ops/pallas_triplane.py
// triplane_sample_tiles (entered through sample_from_planes_fused; kernel
// _sample_kernel_resident), which computes render/renderer.py
// sample_from_planes: every (N, M, 3) point, scaled by 2 / box_warp, is
// projected onto the 3 planes (plane 0 takes (x, y), plane 1 (x, z),
// plane 2 (z, y)) and sampled bilinearly with zeros padding and
// align_corners=False, giving (N, 3, M, C).
//
// What bounds it on the H100: bytes. Per launch of a 512^2 forward's pass
// (N = 4, M = 196,608, C = 32) it reads 100.7 MB of float32 planes and 9.4
// MB of coordinates and writes 302 MB of output, against 8 float
// operations a tap and channel. The planes are laid out channels-last,
// (N * 3, H, W, C), once per forward by the wrapper, so a tap's C channels
// are one contiguous line.
//
// Design: a group of C / 4 lanes owns one point (8 lanes at C = 32), and
// each lane owns 4 channels of all 3 planes. The point's coordinates, its
// 3 x 4 tap addresses and weights are computed once per lane in 32-bit
// integers (no division by a runtime value beyond the one that splits the
// point index into (image, point)). Each tap is one read a lane through
// the read-only path (__ldg), 16 bytes in float32 and 8 in bf16, so a
// point's tap on one plane is one line across its lanes (128 B in float32,
// 64 B in bf16); a lane issues its 12 independent taps before it uses any
// of them. Each output is one 16-byte streaming store a lane (__stcs,
// evict-first), a point's 32 channels one full 128 B line, so that the
// output stream does not push the image's planes out of the 50 MB L2.
// Blocks go in point order, image by image, and consecutive points of a
// warp are consecutive depth samples of a ray, whose taps share lines in
// L1.
//
// The bf16 instance (planes stored in bf16, the renderer's gather_bf16
// option; JAX render/renderer.py:50-65) widens each channel exactly to
// float32 (a bf16 is the high half of a float32) and computes the weights
// and the 4-tap sums in float32, as the float32 instance does, and writes
// float32. The JAX package rounds each product and the sum in bf16
// (ops/grid_sample.py:93-99); float32 is more exact and costs the card
// nothing here. Its bytes at a 512^2 pass: 50.3 MB of planes, 9.4 MB of
// coordinates and 302 MB of output. The output, float32 in both instances,
// is 83% of them, so halving the planes barely moves the bound. Its lanes
// keep the float32 instance's layout, 4 channels a lane, with 8-byte taps:
// 4 lanes of 8 channels with 16-byte taps each wrote a point's line as two
// half-sector stores a lane and took 0.1588 ms against the float32
// instance's 0.1486 on an H100 80GB HBM3 at 700 W (PERF.md, section 6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The planes' storage types. A lane reads 4 channels of a tap (16 bytes
// in float32, 8 in bf16) and widens them to float32.
struct F32 {
  using Raw = uint4;
  __device__ static void widen(const uint4 r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
};

struct Bf16 {
  using Raw = uint2;
  // each 32-bit word holds two channels, the first in its low half; a
  // bf16 is the high half of the float32 with the same value
  __device__ static void widen(const uint2 r, float* v) {
    v[0] = __uint_as_float(r.x << 16);
    v[1] = __uint_as_float(r.x & 0xffff0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xffff0000u);
  }
};

template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
triplane_sample_kernel(const typename T::Raw* __restrict__ planes,
                       const float* __restrict__ coords,  // (N, M, 3)
                       float4* __restrict__ out,          // (N, 3, M, C/4)
                       int points, int M, int H, int W, float scale) {
  using Raw = typename T::Raw;
  constexpr int kLanes = kC / 4;
  constexpr int kPointsPerBlock = kThreads / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int point = blockIdx.x * kPointsPerBlock + threadIdx.x / kLanes;
  if (point >= points) return;
  const int n = point / M;
  const int m = point - n * M;

  const float x = scale * __ldg(coords + 3 * point);
  const float y = scale * __ldg(coords + 3 * point + 1);
  const float z = scale * __ldg(coords + 3 * point + 2);

  Raw tap[3][4];
  float w[3][4];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float gx = (p == 2) ? z : x;
    const float gy = (p == 1) ? z : y;
    // unnormalize (align_corners=False); far-out points are clamped to a
    // range whose taps are all outside the plane, which keeps the float ->
    // int conversion defined
    const float ix = fminf(fmaxf((gx + 1.f) * (0.5f * W) - 0.5f, -2.f),
                           W + 1.f);
    const float iy = fminf(fmaxf((gy + 1.f) * (0.5f * H) - 0.5f, -2.f),
                           H + 1.f);
    const float fx0 = floorf(ix), fy0 = floorf(iy);
    const float wx1 = ix - fx0, wy1 = iy - fy0;
    const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;
    const int x0 = (int)fx0, y0 = (int)fy0;
    const Raw* plane = planes + (n * 3 + p) * H * W * kLanes + lane;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int xi = x0 + (k & 1), yi = y0 + (k >> 1);
      w[p][k] = ((k >> 1) ? wy1 : wy0) * ((k & 1) ? wx1 : wx0);
      tap[p][k] = (xi >= 0 && xi < W && yi >= 0 && yi < H)
          ? __ldg(plane + (yi * W + xi) * kLanes)
          : Raw{};
    }
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v[4];
      T::widen(tap[p][k], v);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += v[c] * w[p][k];
    }
    __stcs(out + ((n * 3 + p) * M + m) * kLanes + lane,
           make_float4(acc[0], acc[1], acc[2], acc[3]));
  }
}

// The backward with respect to the planes: the transpose of the forward.
// Every (point, plane, tap) adds its bilinear weight times the point's
// output gradient into that tap's texel of grad_planes, which the caller
// zero-fills, channels-last like the planes.
//
// What bounds it on the H100: bytes, if each texel's gradient were written
// once (302 MB of grad_out and 9.4 MB of points read, 100.7 MB of
// grad_planes written at a 512^2 pass). A scatter instead issues one float4
// atomic a lane per (point, plane, in-range tap): 8.8 M line atomics at
// that pass, and the L2's rate for them sets the time, not the bytes and
// not their contention on shared texels (the same points in a shuffled
// order take as long on the H100; PERF.md, section 6).
//
// Design: merge taps before the atomics. A block works on one plane
// (blockIdx.y). A group of C / 4 lanes (a lane owns 4 channels) walks a run
// of kRun consecutive points and keeps the current cell's 4 taps' partial
// sums in registers. It flushes them, one float4 atomic a lane per in-range
// tap, when the cell or the image changes and at the end of the run, so
// the result is exact whatever the geometry; only the count of atomics
// depends on it. grad_out is loaded kAhead points at a time, before their
// adds. Along a ray, plane 0's (x, y) cell repeats for a sample or two;
// planes 1 and 2 change cell at every sample, so this removes 16% of the
// atomics at the coarse pass. ops/triplane.py merge_plain models the merge
// (the same cells and runs): its contributions added up give the plain
// backward, and it counts the atomics. The atomics land in no fixed order,
// so the sums are not bit-reproducible.

// A point's cell on one plane and its bilinear weights. The roundings are
// written out (nvcc contracts none of them) and are merge_plain's, so that
// the kernel and its model see the same cells.
struct Cell {
  int x0, y0;
  float wx1, wy1;
};

__device__ __forceinline__ float unnormalize(float g, int size) {
  // align_corners=False; far-out points are clamped to a range whose taps
  // are all outside the plane, which keeps the float -> int conversion
  // defined
  return fminf(fmaxf(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.f), 0.5f * size),
                               0.5f), -2.f), size + 1.f);
}

__device__ __forceinline__ Cell cell_of(float gx, float gy, int H, int W) {
  const float ix = unnormalize(gx, W), iy = unnormalize(gy, H);
  const float fx0 = floorf(ix), fy0 = floorf(iy);
  return Cell{(int)fx0, (int)fy0, ix - fx0, iy - fy0};
}

// ops/triplane.py RUN names the same run length
constexpr int kRun = 32;

template <int kC>
__global__ void __launch_bounds__(kThreads)
triplane_sample_backward_kernel(const float4* __restrict__ grad_out,
                                const float* __restrict__ coords,
                                float4* __restrict__ grad_planes,
                                int points, int M, int H, int W,
                                float scale) {
  constexpr int kLanes = kC / 4;
  constexpr int kGroups = kThreads / kLanes;
  constexpr int kAhead = 8;
  static_assert(kRun % kAhead == 0, "run length");

  const int p = blockIdx.y;
  const int group = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int first = (blockIdx.x * kGroups + group) * kRun;
  const int last = min(first + kRun, points);
  // plane 0 samples (x, y), plane 1 (x, z), plane 2 (z, y); texel (n, y, x)
  // of plane p is line ((n * 3 + p) * H + y) * W + x of grad_planes
  const int ax = (p == 2) ? 2 : 0, ay = (p == 1) ? 2 : 1;

  // the run: the open cell (cn < 0: none) and its 4 taps' partial sums
  int cn = -1, cx = 0, cy = 0;
  float4 acc[4];
  auto flush = [&]() {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int xi = cx + (k & 1), yi = cy + (k >> 1);
      if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
      // one 16-byte atomic on global memory (compute capability 9.x; the
      // float4 overload is in CUDA 12's sm_90_rt.h)
      atomicAdd(grad_planes + (((cn * 3 + p) * H + yi) * W + xi) * kLanes
                + lane, acc[k]);
    }
  };

  int n = first / M, m = first - n * M;
  for (int base = first; base < last; base += kAhead) {
    float4 g[kAhead];
    float gx[kAhead], gy[kAhead];
    int gn[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = base + u;
      gn[u] = n;
      if (i < last) {
        g[u] = __ldcs(grad_out + ((n * 3 + p) * M + m) * kLanes + lane);
        gx[u] = __ldg(coords + 3 * i + ax);
        gy[u] = __ldg(coords + 3 * i + ay);
      }
      if (++m == M) m = 0, ++n;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (base + u >= last) break;
      const Cell c = cell_of(__fmul_rn(scale, gx[u]), __fmul_rn(scale, gy[u]),
                             H, W);
      if (gn[u] != cn || c.x0 != cx || c.y0 != cy) {
        if (cn >= 0) flush();
        cn = gn[u], cx = c.x0, cy = c.y0;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float wx0 = 1.f - c.wx1, wy0 = 1.f - c.wy1;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float w = ((k >> 1) ? c.wy1 : wy0) * ((k & 1) ? c.wx1 : wx0);
        acc[k].x += w * g[u].x;
        acc[k].y += w * g[u].y;
        acc[k].z += w * g[u].z;
        acc[k].w += w * g[u].w;
      }
    }
  }
  if (cn >= 0) flush();
}


template <typename T>
int launch_sample(const void* planes, const void* coords, void* out, int n,
                  int m, int h, int w, int c, float scale, void* stream) {
  constexpr int kC = 32;
  if (c != kC) return (int)cudaErrorInvalidValue;
  const int points = n * m;
  if (points == 0) return 0;
  constexpr int kPointsPerBlock = kThreads / (kC / 4);
  const int blocks = (points + kPointsPerBlock - 1) / kPointsPerBlock;
  triplane_sample_kernel<T, kC>
      <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const typename T::Raw*)planes, (const float*)coords, (float4*)out,
          points, m, h, w, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// c must be 32 (the only instance); the wrapper checks it, and that every
// index of planes, coordinates and output fits in 32 bits, and that planes
// are 16-byte aligned. Planes in float32, or in bf16 (_bf16); coordinates
// and output in float32.
extern "C" int triplane_sample(const void* planes, const void* coords,
                               void* out, int n, int m, int h, int w, int c,
                               float scale, void* stream) {
  return launch_sample<F32>(planes, coords, out, n, m, h, w, c, scale,
                            stream);
}

extern "C" int triplane_sample_bf16(const void* planes, const void* coords,
                                    void* out, int n, int m, int h, int w,
                                    int c, float scale, void* stream) {
  return launch_sample<Bf16>(planes, coords, out, n, m, h, w, c, scale,
                             stream);
}

// grad_planes must be zero-filled; the wrapper checks what it checks for
// the forward.
extern "C" int triplane_sample_backward(const void* grad_out,
                                        const void* coords, void* grad_planes,
                                        int n, int m, int h, int w, int c,
                                        float scale, void* stream) {
  constexpr int kC = 32;
  if (c != kC) return (int)cudaErrorInvalidValue;
  const int points = n * m;
  if (points == 0) return 0;
  constexpr int kPointsPerBlock = kThreads / (kC / 4) * kRun;
  const dim3 grid((points + kPointsPerBlock - 1) / kPointsPerBlock, 3);
  triplane_sample_backward_kernel<kC>
      <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          (const float4*)grad_out, (const float*)coords,
          (float4*)grad_planes, points, m, h, w, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* triplane_sample_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
