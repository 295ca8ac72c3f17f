// Per-face z-buffer triangle rasterizer for Hopper (sm_90a): K5.
//
// Replaces the TPU kernel next3d_tpu/ops/pallas_raster.py
// rasterize_mesh_pallas (kernel _raster_kernel), with its prep. Three
// kernels, reached through two C entry points:
//   raster_zbuffer_prep  a thread per (image, face): the face's pixel-space
//                        corners, depths, inverse area (0 for a culled
//                        face) and stripe start row, as
//                        next3d_tpu_torch/ops/raster_zbuffer.py
//                        zbuffer_prep computes them;
//   raster_zbuffer       the face kernel, then the decode.
//
// Semantics, those of the TPU kernel's sequential face loop: a kept face
// may write only its stripe, rows [y0, y0 + stripe_h) at full width (a face
// taller than the stripe is cut); a stripe pixel is inside when its three
// barycentrics are all >= 0, and its depth interpolates the corners'; the
// smallest z wins, on a z tie the earlier face wins, and a z of 1e10 or more
// never wins.
//
// Rounding: the fused form of the JAX reference as XLA compiles it on the
// CPU (see raster_zbuffer.py), area = fma(x1-x0, y2-y0, -((y1-y0)*(x2-x0))),
// b0 = fl(fma(cx-bx, py-by, -((cy-by)*(px-bx))) * inv) and its two cyclic
// copies, z = fma(b2, cz, fma(b0, az, b1*bz)). Each fused step is an
// __fmaf_rn and every other step an __fsub_rn / __fmul_rn / __fadd_rn, so
// nvcc contracts nothing else and the kernels stay bit-equal to the plain
// version, which tests/test_torch_raster_variants.py holds bit for bit to
// JAX's interpret-mode kernel (test_k5_matches_jax_on_slivers).
//
// Order: a TPU core walked the faces in order with the z-buffer in VMEM.
// Here the faces run in parallel and the order lives in a key instead: the
// face kernel does a 64-bit atomicMin of (ordered(z) << 32) | face into a
// (B, H, W) int64 scratch, where ordered() maps the float bits to a signed
// int that orders as the floats do (negative depths too; -0 is folded into
// +0), so the smallest key is the smallest z and then the earliest face.
// The scratch starts at the key of (1e10, face 0), which no z >= 1e10 can
// undercut. The decode turns each key into pix_to_face (-1 where
// untouched) and zbuf (1e10 there).
//
// Face kernel, coarse to fine: a warp per (image, face), 8 faces a block; a
// culled face's warp exits at once. Level 0: a lane per 8-px column strip
// of the stripe (the strip as high as the stripe), a corner test, a ballot.
// Level 1: a lane per (surviving strip, 8x4 sub-tile) pair, a corner test,
// a ballot. Fine: each surviving sub-tile is one warp iteration, a pixel a
// lane, the per-pixel test, then the atomicMin. No integer division runs
// in the loops.
//
// The corner test is exact. In the rounded barycentric above, fl(py - y)
// and fl(ey * fl(px - x)) are monotone in py and px, a single-rounded fma
// is monotone in its addend and, for a fixed ex, in dy (in the direction
// of ex's sign), and fl(w * inv) with inv > 0 is monotone in w. So over a
// rectangle of pixels the value is largest at the corner with the
// smallest x if ey >= 0 (else the largest) and the largest y if ex >= 0
// (else the smallest), and the test computes it there with the same
// expression. A rectangle is culled only when one barycentric's corner
// value is < 0: then that barycentric is < 0 or NaN at every pixel of it,
// and the per-pixel test fails there too. A NaN corner keeps the rectangle
// (the fine test decides). Culling removes no covering (face, pixel) pair,
// so the outputs stay bit-equal; raster_zbuffer.py cull_plain mirrors both
// levels for the CPU tests. A padded bbox walk would not be exact: for a
// near-degenerate sliver the rounded test passes pixels far outside the
// face's bbox, along the line through its long edge.
//
// What bounds it on the H100: instruction throughput over many short
// warps, not bytes. The first design tested every (kept face, stripe
// pixel) pair, about 8e8 tests for 16 images at 256^2; now a kept face
// costs one level-0 iteration (32 strips at 256 px), one or two level-1
// iterations and one fine iteration per surviving sub-tile, a few hundred
// warp instructions. Builds cut after each level put most of the time in
// level 1 (three corner values a pair), then the fine level; the atomics,
// which touch only covered pixels, cost little. Occupancy is not the
// limit: the kernel is held to 32 registers for 8 blocks an SM, and lanes
// load a face's 10 values in parallel, which together gained only a
// little. The decode and the scratch's fill move 16 B and 8 B a pixel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSubW = 8;  // strip and sub-tile width, px (SUB_W)
constexpr int kSubH = 4;  // sub-tile height, px (SUB_H)
constexpr float kBigZ = 1e10f;
constexpr int kFaces = 1, kDecode = 2;  // stages of raster_zbuffer

__device__ __forceinline__ long long pack(float z, int face) {
  const int bits = __float_as_int(__fadd_rn(z, 0.0f));  // -0 -> +0
  const int ordered = bits < 0 ? bits ^ 0x7FFFFFFF : bits;
  return (long long)(((unsigned long long)(unsigned)ordered << 32)
                     | (unsigned)face);
}

__device__ __forceinline__ float to_pixel(float v, float half) {
  // (v + 1) * (S / 2) - 0.5
  return __fsub_rn(__fmul_rn(__fadd_rn(v, 1.f), half), 0.5f);
}

// An edge's vector (ex, ey) and the corner (x, y) it starts from.
struct Edge {
  float ex, ey, x, y;
};

// The barycentric of the edge at pixel (px, py), rounded as the reference
// rounds it: fl(fma(ex, py - y, -(ey * (px - x))) * inv).
__device__ __forceinline__ float bary(const Edge& e, float inv, float px,
                                      float py) {
  return __fmul_rn(__fmaf_rn(e.ex, __fsub_rn(py, e.y),
                             -__fmul_rn(e.ey, __fsub_rn(px, e.x))),
                   inv);
}

// Whether the rectangle [x0, x0 + kSubW - 1] x [y0, y1] may hold a pixel
// that passes the per-pixel test: no barycentric's largest value over it
// (at its corner, see the header) is < 0.
__device__ __forceinline__ bool corner_keeps(const Edge* e, float inv,
                                             float x0, float y0, float y1) {
  bool keep = true;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    keep &= !(bary(e[i], inv, e[i].ey >= 0.f ? x0 : x0 + (kSubW - 1),
                   e[i].ex >= 0.f ? y1 : y0) < 0.f);
  return keep;
}

__global__ void __launch_bounds__(kThreads)
zbuffer_prep_kernel(const float* __restrict__ verts,     // (B, V, 3)
                    const int64_t* __restrict__ faces,   // (F, 3)
                    float* __restrict__ face_data,       // (B, 10, F)
                    int32_t* __restrict__ y0s,           // (B, F)
                    int num_verts, int num_faces, int size, int stripe_h) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (f >= num_faces) return;
  const float half = 0.5f * size;
  const float* vb = verts + (int64_t)b * num_verts * 3;
  float x[3], y[3], z[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* v = vb + faces[3 * f + i] * 3;
    x[i] = to_pixel(v[0], half);
    y[i] = to_pixel(v[1], half);
    z[i] = v[2];
  }
  const float area = __fmaf_rn(
      __fsub_rn(x[1], x[0]), __fsub_rn(y[2], y[0]),
      -__fmul_rn(__fsub_rn(y[1], y[0]), __fsub_rn(x[2], x[0])));
  const float inv = area > 1e-8f ? __frcp_rn(area) : 0.f;
  float* d = face_data + (int64_t)b * 10 * num_faces + f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    d[i * num_faces] = x[i];
    d[(3 + i) * num_faces] = y[i];
    d[(6 + i) * num_faces] = z[i];
  }
  d[9 * num_faces] = inv;
  // the 8-aligned row at or above ceil(ymin), kept inside the image (for a
  // kept face ymin is finite, and clamping it first changes nothing)
  const float ymin = fminf(fminf(y[0], y[1]), y[2]);
  const int top = (int)ceilf(fminf(fmaxf(ymin, -16.f), size + 16.f));
  y0s[(int64_t)b * num_faces + f] = min(max(top & ~7, 0), size - stripe_h);
}

__global__ void __launch_bounds__(kThreads, 8)
zbuffer_faces_kernel(const float* __restrict__ face_data,  // (B, 10, F)
                     const int32_t* __restrict__ y0s,      // (B, F)
                     long long* __restrict__ keys,          // (B, H, W)
                     int faces, int height, int width, int stripe_h) {
  __shared__ int strip_list[kWarps][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int f = blockIdx.x * kWarps + warp;
  const int b = blockIdx.y;
  if (f >= faces) return;
  // lane j < 10 loads the face's row j, then each value is broadcast
  const float* d = face_data + (int64_t)b * 10 * faces + f;
  const float row = lane < 10 ? d[(int64_t)lane * faces] : 0.f;
  const float inv = __shfl_sync(0xffffffffu, row, 9);
  if (!(inv > 0.f)) return;
  const float ax = __shfl_sync(0xffffffffu, row, 0);
  const float bx = __shfl_sync(0xffffffffu, row, 1);
  const float cx = __shfl_sync(0xffffffffu, row, 2);
  const float ay = __shfl_sync(0xffffffffu, row, 3);
  const float by = __shfl_sync(0xffffffffu, row, 4);
  const float cy = __shfl_sync(0xffffffffu, row, 5);
  const float az = __shfl_sync(0xffffffffu, row, 6);
  const float bz = __shfl_sync(0xffffffffu, row, 7);
  const float cz = __shfl_sync(0xffffffffu, row, 8);
  const Edge e[3] = {{__fsub_rn(cx, bx), __fsub_rn(cy, by), bx, by},
                     {__fsub_rn(ax, cx), __fsub_rn(ay, cy), cx, cy},
                     {__fsub_rn(bx, ax), __fsub_rn(by, ay), ax, ay}};
  const int top = y0s[(int64_t)b * faces + f];
  const float y_lo = (float)top, y_hi = (float)(top + stripe_h - 1);
  long long* img = keys + (int64_t)b * height * width;
  const int strips = width / kSubW;
  const int subs = stripe_h / kSubH;
  // level 1 numbers its pairs p = i * subs + k (i-th surviving strip,
  // sub-tile k); a lane starts at p = lane and steps by 32
  const int i0 = lane / subs, k0 = lane % subs;
  const int di = 32 / subs, dk = 32 % subs;

  for (int s0 = 0; s0 < strips; s0 += 32) {
    // level 0: strip s0 + lane over the whole stripe
    const int s = s0 + lane;
    const bool keep = s < strips
        && corner_keeps(e, inv, (float)(s * kSubW), y_lo, y_hi);
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (keep) strip_list[warp][__popc(mask & ((1u << lane) - 1))] = s;
    __syncwarp();
    const int n = __popc(mask);
    int i = i0, k = k0;
    for (int p0 = 0; p0 < n * subs; p0 += 32) {
      // level 1: sub-tile k of the i-th surviving strip
      float sx = 0.f, sy = 0.f;
      bool keep1 = false;
      if (i < n) {
        sx = (float)(strip_list[warp][i] * kSubW);
        sy = y_lo + (float)(k * kSubH);
        keep1 = corner_keeps(e, inv, sx, sy, sy + (kSubH - 1));
      }
      // fine: each surviving sub-tile, a pixel a lane
      for (unsigned todo = __ballot_sync(0xffffffffu, keep1); todo;
           todo &= todo - 1) {
        const int j = __ffs(todo) - 1;
        const float px =
            __shfl_sync(0xffffffffu, sx, j) + (float)(lane % kSubW);
        const float py =
            __shfl_sync(0xffffffffu, sy, j) + (float)(lane / kSubW);
        const float b0 = bary(e[0], inv, px, py);
        const float b1 = bary(e[1], inv, px, py);
        const float b2 = bary(e[2], inv, px, py);
        if (b0 >= 0.f && b1 >= 0.f && b2 >= 0.f) {
          const float z =
              __fmaf_rn(b2, cz, __fmaf_rn(b0, az, __fmul_rn(b1, bz)));
          if (z < kBigZ)
            atomicMin(&img[(int64_t)(int)py * width + (int)px], pack(z, f));
        }
      }
      i += di;
      k += dk;
      if (k >= subs) {
        k -= subs;
        ++i;
      }
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
zbuffer_decode_kernel(const long long* __restrict__ keys,
                      int32_t* __restrict__ pix_to_face,
                      float* __restrict__ zbuf, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long k = keys[i];
  if (k == pack(kBigZ, 0)) {
    pix_to_face[i] = -1;
    zbuf[i] = kBigZ;
    return;
  }
  const int ordered = (int)(k >> 32);
  pix_to_face[i] = (int32_t)(k & 0xFFFFFFFFLL);
  zbuf[i] = __int_as_float(ordered < 0 ? ordered ^ 0x7FFFFFFF : ordered);
}

}  // namespace

// faces (F, 3) int64 indexes verts (B, V, 3) float32; writes face_data
// (B, 10, F) and y0s (B, F) int32.
extern "C" int raster_zbuffer_prep(const void* verts, const void* faces,
                                   void* face_data, void* y0s, int batch,
                                   int num_verts, int num_faces, int size,
                                   int stripe_h, void* stream) {
  zbuffer_prep_kernel<<<dim3((num_faces + kThreads - 1) / kThreads, batch),
                        kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)verts, (const int64_t*)faces, (float*)face_data,
      (int32_t*)y0s, num_verts, num_faces, size, stripe_h);
  return (int)cudaGetLastError();
}

// stages: 1 the face kernel (keys must hold (B, H, W) int64 set to the key
// of (1e10, face 0)), 2 the decode of keys into pix_to_face and zbuf, 3
// both in turn.
extern "C" int raster_zbuffer(const void* face_data, const void* y0s,
                              void* keys, void* pix_to_face, void* zbuf,
                              int batch, int faces, int height, int width,
                              int stripe_h, int stages, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (stages & kFaces) {
    zbuffer_faces_kernel<<<dim3((faces + kWarps - 1) / kWarps, batch),
                           kThreads, 0, s>>>(
        (const float*)face_data, (const int32_t*)y0s, (long long*)keys,
        faces, height, width, stripe_h);
    cudaError_t status = cudaGetLastError();
    if (status != cudaSuccess) return (int)status;
  }
  if (stages & kDecode) {
    const int64_t n = (int64_t)batch * height * width;
    zbuffer_decode_kernel<<<(unsigned)((n + kThreads - 1) / kThreads),
                            kThreads, 0, s>>>(
        (const long long*)keys, (int32_t*)pix_to_face, (float*)zbuf, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* raster_zbuffer_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
