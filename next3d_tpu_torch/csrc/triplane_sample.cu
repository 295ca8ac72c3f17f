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
// (N = 4, M = 196,608, C = 32) it reads 100.7 MB of planes and 9.4 MB of
// coordinates and writes 302 MB of output, against 8 float operations a
// tap and channel. The planes are laid out channels-last, (N * 3, H, W, C),
// once per forward by the wrapper, so a tap's C channels are one
// contiguous 128 B line.
//
// Design: a group of C / 4 lanes owns one point (8 lanes at C = 32), and
// each lane owns 4 channels of all 3 planes. The point's coordinates, its
// 3 x 4 tap addresses and weights are computed once per lane in 32-bit
// integers (no division by a runtime value beyond the one that splits the
// point index into (image, point)). Each tap is one 16-byte read through
// the read-only path (__ldg), so a point's tap on one plane is one 128 B
// line across its lanes; a lane issues its 12 independent taps before it
// uses any of them. Each output is one 16-byte streaming store (__stcs,
// evict-first), so that the output stream does not push the image's 25 MB
// of planes out of the 50 MB L2. Blocks go in point order, image by image,
// and consecutive points of a warp are consecutive depth samples of a ray,
// whose taps share lines in L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int kC>
__global__ void __launch_bounds__(kThreads)
triplane_sample_kernel(const float4* __restrict__ planes,  // (N*3, H, W, C/4)
                       const float* __restrict__ coords,   // (N, M, 3)
                       float4* __restrict__ out,           // (N, 3, M, C/4)
                       int points, int M, int H, int W, float scale) {
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

  float4 tap[3][4];
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
    const float4* plane = planes + (n * 3 + p) * H * W * kLanes + lane;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int xi = x0 + (k & 1), yi = y0 + (k >> 1);
      w[p][k] = ((k >> 1) ? wy1 : wy0) * ((k & 1) ? wx1 : wx0);
      tap[p][k] = (xi >= 0 && xi < W && yi >= 0 && yi < H)
          ? __ldg(plane + (yi * W + xi) * kLanes)
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc.x += tap[p][k].x * w[p][k];
      acc.y += tap[p][k].y * w[p][k];
      acc.z += tap[p][k].z * w[p][k];
      acc.w += tap[p][k].w * w[p][k];
    }
    __stcs(out + ((n * 3 + p) * M + m) * kLanes + lane, acc);
  }
}

// The backward with respect to the planes: the transpose of the forward.
// Every (point, plane, tap) adds its bilinear weight times the point's
// output gradient into that tap's texel of grad_planes, which the caller
// zero-fills, channels-last like the planes. The mapping is the forward's:
// C / 4 lanes a point, each lane owns 4 channels, reads one float4 of
// grad_out a plane and scatters each of the plane's 4 in-range taps with
// one vector atomic. Consecutive points of a warp are consecutive depth
// samples of a ray and hit the same texels, so those atomics contend; the
// order in which they land varies, so the sums are not bit-reproducible.
template <int kC>
__global__ void __launch_bounds__(kThreads)
triplane_sample_backward_kernel(const float4* __restrict__ grad_out,
                                const float* __restrict__ coords,
                                float4* __restrict__ grad_planes,
                                int points, int M, int H, int W,
                                float scale) {
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
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float gx = (p == 2) ? z : x;
    const float gy = (p == 1) ? z : y;
    const float ix = fminf(fmaxf((gx + 1.f) * (0.5f * W) - 0.5f, -2.f),
                           W + 1.f);
    const float iy = fminf(fmaxf((gy + 1.f) * (0.5f * H) - 0.5f, -2.f),
                           H + 1.f);
    const float fx0 = floorf(ix), fy0 = floorf(iy);
    const float wx1 = ix - fx0, wy1 = iy - fy0;
    const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;
    const int x0 = (int)fx0, y0 = (int)fy0;
    const float4 g = __ldcs(grad_out + ((n * 3 + p) * M + m) * kLanes + lane);
    float4* plane = grad_planes + (n * 3 + p) * H * W * kLanes + lane;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int xi = x0 + (k & 1), yi = y0 + (k >> 1);
      if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
      const float w = ((k >> 1) ? wy1 : wy0) * ((k & 1) ? wx1 : wx0);
      float4* dst = plane + (yi * W + xi) * kLanes;
      // one 16-byte atomic on global memory (compute capability 9.x; the
      // float4 overload is in CUDA 12's sm_90_rt.h)
      atomicAdd(dst, make_float4(w * g.x, w * g.y, w * g.z, w * g.w));
    }
  }
}

}  // namespace

// c must be 32 (the only instance); the wrapper checks it, and that every
// index of planes, coordinates and output fits in 32 bits, and that planes
// are 16-byte aligned.
extern "C" int triplane_sample(const void* planes, const void* coords,
                               void* out, int n, int m, int h, int w, int c,
                               float scale, void* stream) {
  constexpr int kC = 32;
  if (c != kC) return (int)cudaErrorInvalidValue;
  const int points = n * m;
  if (points == 0) return 0;
  constexpr int kPointsPerBlock = kThreads / (kC / 4);
  const int blocks = (points + kPointsPerBlock - 1) / kPointsPerBlock;
  triplane_sample_kernel<kC><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)planes, (const float*)coords, (float4*)out, points, m, h,
      w, scale);
  return (int)cudaGetLastError();
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
  constexpr int kPointsPerBlock = kThreads / (kC / 4);
  const int blocks = (points + kPointsPerBlock - 1) / kPointsPerBlock;
  triplane_sample_backward_kernel<kC>
      <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const float4*)grad_out, (const float*)coords,
          (float4*)grad_planes, points, m, h, w, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* triplane_sample_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
