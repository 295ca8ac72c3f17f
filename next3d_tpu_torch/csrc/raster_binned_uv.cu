// Binned triangle rasterizers for Hopper (sm_90a): K1, K2 and K3.
//
// One template, three instances, each with its own C entry point:
//   raster_binned_uv    K1, 32-px tiles, emits (pix_to_face, u, v); replaces
//                       next3d_tpu/ops/pallas_raster.py
//                       rasterize_mesh_pallas_binned_uv (kernel
//                       _binned_attr_kernel);
//   raster_binned       K2, 32-px tiles, emits (pix_to_face, zbuf); replaces
//                       rasterize_mesh_pallas_binned (kernel _binned_kernel);
//   raster_binned_uv16  K3, 16-px tiles, emits (pix_to_face, u, v); replaces
//                       rasterize_mesh_pallas_binned_uv16 (kernel
//                       _binned_attr_kernel16).
// The prep (per-face affine coefficients, the tile entries of each face, a
// stable sort by tile id and the segment starts) runs in torch:
// next3d_tpu_torch/ops/raster.py binned_prep.
//
// Semantics, per pixel of a (B, H, W) image: among the candidate faces of
// the pixel's tile whose three edge functions are all >= 0, the one with
// the smallest z wins, ties going to the smaller face id; the output is its
// id and its affine (u, v) or its z, or -1 / 0 / 0 (K1, K3) and -1 / 1e10
// (K2) when no face covers the pixel. Every coefficient row is evaluated
// as (c + x*gx) + y*gy with __fmul_rn / __fadd_rn: nvcc would otherwise
// contract it into an FMA, which rounds differently from the plain torch
// version and can flip pixels on triangle edges. The three instances share
// that arithmetic and the coefficients, so they agree with each other bit
// for bit on the pixels they all emit.
//
// What bounds them on the H100: instruction throughput. A tile's pixels are
// tested against every candidate of its segment (about 1024 x 600 edge/depth
// evaluations for a 32-px tile of a 256^2 view of the FLAME-sized head),
// while the coefficient bytes (13 or 19 floats a candidate, read once per
// tile) are small. The design keeps everything that is reused on chip: one
// block per (image, tile), 256 threads each owning TILE^2 / 256 pixels
// (4 at 32 px, 1 at 16 px) whose (z, face, payload) carry stays in
// registers, and the segment streamed through shared memory in chunks of
// 256 candidates, which every thread then reads as a broadcast. There is no
// cap on the segment length (the TPU kernels' MAX_SEG window): a tile reads
// its whole segment.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;
constexpr float kBigZ = 1e10f;
constexpr float kNoFace = 1073741824.0f;  // 2^30

__device__ __forceinline__ float affine(float c, float x, float y, float gx,
                                        float gy) {
  return __fadd_rn(__fadd_rn(c, __fmul_rn(x, gx)), __fmul_rn(y, gy));
}

// kUV: the slab has 19 rows (b0 b1 b2 z u v, each (c, x, y), then the face
// id) and the outputs are (pix_to_face, u, v); otherwise 13 rows (no u, v)
// and the outputs are (pix_to_face, zbuf), with out1 unused.
template <int kTile, bool kUV>
__global__ void __launch_bounds__(kThreads)
raster_binned_kernel(const float* __restrict__ slab,     // (B, K, E)
                     const int32_t* __restrict__ starts,  // (B, T + 1)
                     int32_t* __restrict__ pix_to_face,   // (B, H, W)
                     float* __restrict__ out0, float* __restrict__ out1,
                     int entries, int tiles_x, int tiles, int width,
                     int height) {
  constexpr int kCoeffs = kUV ? 19 : 13;
  constexpr int kFid = kCoeffs - 1;
  constexpr int kPixPerThread = kTile * kTile / kThreads;
  constexpr int kRowStep = kThreads / kTile;
  __shared__ float sh[kCoeffs][kChunk];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int start = starts[b * (tiles + 1) + t];
  const int end = starts[b * (tiles + 1) + t + 1];
  const float* seg = slab + (int64_t)b * kCoeffs * entries;

  const int col = tid % kTile;
  const int row0 = (t / tiles_x) * kTile + tid / kTile;
  const float gx = (float)((t % tiles_x) * kTile + col);
  float gy[kPixPerThread], zb[kPixPerThread], fb[kPixPerThread];
  float ub[kPixPerThread], vb[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    gy[k] = (float)(row0 + k * kRowStep);
    zb[k] = kBigZ;
    fb[k] = kNoFace;
    ub[k] = 0.f;
    vb[k] = 0.f;
  }

  for (int base = start; base < end; base += kChunk) {
    const int n = min(kChunk, end - base);
    if (tid < n) {
#pragma unroll
      for (int j = 0; j < kCoeffs; ++j)
        sh[j][tid] = seg[(int64_t)j * entries + base + tid];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float fid = sh[kFid][i];
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        const float w0 = affine(sh[0][i], sh[1][i], sh[2][i], gx, gy[k]);
        const float w1 = affine(sh[3][i], sh[4][i], sh[5][i], gx, gy[k]);
        const float w2 = affine(sh[6][i], sh[7][i], sh[8][i], gx, gy[k]);
        if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f) {
          const float z = affine(sh[9][i], sh[10][i], sh[11][i], gx, gy[k]);
          if (z < zb[k] || (z == zb[k] && fid < fb[k])) {
            zb[k] = z;
            fb[k] = fid;
            if constexpr (kUV) {
              ub[k] = affine(sh[12][i], sh[13][i], sh[14][i], gx, gy[k]);
              vb[k] = affine(sh[15][i], sh[16][i], sh[17][i], gx, gy[k]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int64_t o = ((int64_t)b * height + row0 + k * kRowStep) * width
        + (t % tiles_x) * kTile + col;
    const bool hit = fb[k] < kNoFace;
    pix_to_face[o] = hit ? (int32_t)fb[k] : -1;
    if constexpr (kUV) {
      out0[o] = hit ? ub[k] : 0.f;
      out1[o] = hit ? vb[k] : 0.f;
    } else {
      out0[o] = zb[k];  // kBigZ where no face won
    }
  }
}

template <int kTile, bool kUV>
int launch(const void* slab, const void* starts, void* pix_to_face,
           void* out0, void* out1, int batch, int entries, int height,
           int width, void* stream) {
  const int tiles_x = width / kTile;
  const int tiles = tiles_x * (height / kTile);
  dim3 grid(tiles, batch);
  raster_binned_kernel<kTile, kUV><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)slab, (const int32_t*)starts, (int32_t*)pix_to_face,
      (float*)out0, (float*)out1, entries, tiles_x, tiles, width, height);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int raster_binned_uv(const void* slab, const void* starts,
                                void* pix_to_face, void* u, void* v,
                                int batch, int entries, int height, int width,
                                void* stream) {
  return launch<32, true>(slab, starts, pix_to_face, u, v, batch, entries,
                          height, width, stream);
}

extern "C" int raster_binned_uv16(const void* slab, const void* starts,
                                  void* pix_to_face, void* u, void* v,
                                  int batch, int entries, int height,
                                  int width, void* stream) {
  return launch<16, true>(slab, starts, pix_to_face, u, v, batch, entries,
                          height, width, stream);
}

extern "C" int raster_binned(const void* slab, const void* starts,
                             void* pix_to_face, void* zbuf, void* unused,
                             int batch, int entries, int height, int width,
                             void* stream) {
  return launch<32, false>(slab, starts, pix_to_face, zbuf, unused, batch,
                           entries, height, width, stream);
}

extern "C" const char* raster_binned_uv_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
