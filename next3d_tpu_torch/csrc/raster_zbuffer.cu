// Per-face z-buffer triangle rasterizer for Hopper (sm_90a): K5.
//
// Replaces the TPU kernel next3d_tpu/ops/pallas_raster.py
// rasterize_mesh_pallas (kernel _raster_kernel). The per-face inputs
// (pixel-space corners, depths, inverse area, 0 for a culled face) and each
// face's stripe start row are computed in torch:
// next3d_tpu_torch/ops/raster_zbuffer.py zbuffer_prep.
//
// Semantics, those of the TPU kernel's sequential face loop: a kept face
// may write only its stripe, rows [y0, y0 + stripe_h) at full width (a face
// taller than the stripe is cut); a stripe pixel is inside when its three
// barycentrics w_i * inv_area are all >= 0, with
// w0 = (cx-bx)*(py-by) - (cy-by)*(px-bx) and the two cyclic edges, and its
// depth is z = b0*az + b1*bz + b2*cz; the smallest z wins, on a z tie the
// earlier face wins, and a z of 1e10 or more never wins. Every step rounds
// with __fsub_rn / __fmul_rn / __fadd_rn in the plain version's order, so
// nvcc contracts nothing into an FMA and the two agree bit for bit.
//
// A TPU core walked the faces in order with the z-buffer in VMEM. Here the
// faces run in parallel and the order lives in the key instead: pass 1
// does a 64-bit atomicMin of (ordered(z) << 32) | face into a (B, H, W)
// int64 scratch, where ordered() maps the float bits to a signed int that
// orders as the floats do (negative depths too; -0 is folded into +0), so
// the smallest key is the smallest z and then the earliest face. The
// scratch starts at the key of (1e10, face 0), which no z >= 1e10 can
// undercut. Pass 2 decodes each key into pix_to_face (-1 where untouched)
// and zbuf (1e10 there).
//
// What bounds it on the H100: instruction throughput. Pass 1 tests every
// (kept face, stripe pixel) pair, about 23 float operations each: 16 images
// x ~5,000 kept faces x 40 x 256 stripe pixels is about 8e8 tests for the
// flagship's 4-view batch of 4 at 256^2, against 16 x 65,536 x 8 bytes of
// scratch. The design gives each (face, image) one block of 256 threads
// that strides over the stripe, with the face's 10 scalars and its edge
// differences in registers; a culled face's block exits at once; atomics
// are issued only for the pixels a face covers. Pass 2 is one coalesced
// elementwise pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBigZ = 1e10f;

__device__ __forceinline__ long long pack(float z, int face) {
  const int bits = __float_as_int(__fadd_rn(z, 0.0f));  // -0 -> +0
  const int ordered = bits < 0 ? bits ^ 0x7FFFFFFF : bits;
  return (long long)(((unsigned long long)(unsigned)ordered << 32)
                     | (unsigned)face);
}

__global__ void __launch_bounds__(kThreads)
zbuffer_faces_kernel(const float* __restrict__ face_data,  // (B, 10, F)
                     const int32_t* __restrict__ y0s,      // (B, F)
                     long long* __restrict__ keys,          // (B, H, W)
                     int faces, int height, int width, int stripe_h) {
  const int f = blockIdx.x;
  const int b = blockIdx.y;
  const float* d = face_data + (int64_t)b * 10 * faces + f;
  const float inv = d[9 * faces];
  if (!(inv > 0.f)) return;
  const float ax = d[0], bx = d[faces], cx = d[2 * faces];
  const float ay = d[3 * faces], by = d[4 * faces], cy = d[5 * faces];
  const float az = d[6 * faces], bz = d[7 * faces], cz = d[8 * faces];
  const float e0x = __fsub_rn(cx, bx), e0y = __fsub_rn(cy, by);
  const float e1x = __fsub_rn(ax, cx), e1y = __fsub_rn(ay, cy);
  const float e2x = __fsub_rn(bx, ax), e2y = __fsub_rn(by, ay);
  const int y0 = y0s[(int64_t)b * faces + f];
  long long* img = keys + (int64_t)b * height * width;

  for (int p = threadIdx.x; p < stripe_h * width; p += kThreads) {
    const int row = y0 + p / width;
    const int col = p % width;
    const float px = (float)col, py = (float)row;
    const float w0 = __fsub_rn(__fmul_rn(e0x, __fsub_rn(py, by)),
                               __fmul_rn(e0y, __fsub_rn(px, bx)));
    const float w1 = __fsub_rn(__fmul_rn(e1x, __fsub_rn(py, cy)),
                               __fmul_rn(e1y, __fsub_rn(px, cx)));
    const float w2 = __fsub_rn(__fmul_rn(e2x, __fsub_rn(py, ay)),
                               __fmul_rn(e2y, __fsub_rn(px, ax)));
    const float b0 = __fmul_rn(w0, inv);
    const float b1 = __fmul_rn(w1, inv);
    const float b2 = __fmul_rn(w2, inv);
    if (b0 >= 0.f && b1 >= 0.f && b2 >= 0.f) {
      const float z = __fadd_rn(__fadd_rn(__fmul_rn(b0, az), __fmul_rn(b1, bz)),
                                __fmul_rn(b2, cz));
      if (z < kBigZ) atomicMin(&img[(int64_t)row * width + col], pack(z, f));
    }
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

// keys must hold (B, H, W) int64 set to the key of (1e10, face 0).
extern "C" int raster_zbuffer(const void* face_data, const void* y0s,
                              void* keys, void* pix_to_face, void* zbuf,
                              int batch, int faces, int height, int width,
                              int stripe_h, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  zbuffer_faces_kernel<<<dim3(faces, batch), kThreads, 0, s>>>(
      (const float*)face_data, (const int32_t*)y0s, (long long*)keys, faces,
      height, width, stripe_h);
  cudaError_t status = cudaGetLastError();
  if (status != cudaSuccess) return (int)status;
  const int64_t n = (int64_t)batch * height * width;
  zbuffer_decode_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                          0, s>>>((const long long*)keys,
                                  (int32_t*)pix_to_face, (float*)zbuf, n);
  return (int)cudaGetLastError();
}

extern "C" const char* raster_zbuffer_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
