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
// Their input is the prep's slab (per-face affine coefficient rows, grouped
// by tile) and segment starts: on the card csrc/raster_binned_prep.cu
// (next3d_tpu_torch/ops/raster.py binned_prep_cuda), for the plain versions
// the torch binned_prep.
//
// Semantics, per pixel of a (B, H, W) image: among the candidate faces of
// the pixel's tile whose three edge functions are all >= 0, the one with
// the smallest z wins, ties going to the smaller face id; the output is its
// id and its affine (u, v) or its z, or -1 / 0 / 0 (K1, K3) and -1 / 1e10
// (K2) when no face covers the pixel. Every coefficient row is evaluated
// as fma(y, gy, fma(x, gx, c)) with __fmaf_rn, the fused form into which
// XLA compiles the reference on the CPU and which the plain torch version
// evaluates (ops/raster.py row_at): any other rounding can flip pixels on
// triangle edges. The three instances share that arithmetic and the
// coefficients, so they agree with each other bit for bit on the pixels
// they all emit.
//
// Design, coarse to fine. A block of 8 warps takes one image's 16 x 16
// pixel quad and streams the whole segment of the tile that holds it (no
// cap on its length, unlike the TPU kernels' MAX_SEG window) through shared
// memory in chunks of 256 candidates; at 16-px tiles the quad is the tile,
// at 32 px each of a tile's 4 quads reads its segment. Each warp owns one
// 8 x 4 sub-tile, one pixel a lane, whose (z, face, payload) carry stays in
// a register. For each 32 candidates a lane tests one of them against the
// warp's sub-tile (coarse), a ballot gives the warp the mask of candidates
// that survive, and the warp walks that mask with the per-pixel test
// (fine), so every lane runs the same trip count and reads each candidate
// as a shared-memory broadcast: a candidate's rows sit padded to 20 floats,
// so that its edge and depth rows are three float4 loads, broadcast in the
// fine test and without bank conflicts when 32 lanes read 32 candidates.
//
// The coarse test is exact. Its value is the row's own rounded expression
// fma(y, gy, fma(x, gx, c)) at the sub-tile's corner whose x is the largest
// if gx >= 0 (else the smallest) and likewise for y. A fused multiply-add
// rounds its exact value to nearest, which is monotone, so for finite
// coefficients the inner fma is monotone in gx (in x's direction), the outer
// one in its addend and in gy (in y's direction): the expression's largest
// value over the sub-tile's pixels is the one at that corner. An edge whose corner value is not >= 0 (also
// NaN, and -inf, the b0c of a dropped face) therefore fails at every pixel
// of the sub-tile, and culling the candidate there changes no pixel's set of
// covering candidates. The outputs stay bit-equal to the plain version.
//
// What bounds it on the H100: the latency of one warp's fine loop, not
// bytes or the card's operation rate. A FLAME-sized face covers a few
// pixels at 256^2, so the fine test, which the first design ran for every
// pixel of a tile against every candidate of its segment (about 1e8 pairs
// for 16 views), now runs only on the sub-tiles that a face's edges do not
// exclude (about a tenth of those pairs); the coarse test costs 3 affine
// rows a (candidate, sub-tile). But the densest sub-tiles of the head keep
// a few hundred candidates, which their warp walks one after another, each
// a dependent chain of shared-memory loads, rounded affine rows and
// compares; the blocks that hold them set the kernel's time. Sub-tiles of
// one pixel a lane keep that chain as short as it can be with each pixel's
// minimum inside one thread, and 4 quads a 32-px tile spread a heavy tile
// over 4 blocks. The coefficient bytes (13 or 19 floats a candidate, read
// once a quad) and the outputs stay small beside the card's bandwidth.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;
constexpr int kQuad = 16;    // a block's pixels: kQuad x kQuad
constexpr int kSubW = 8;     // a warp's sub-tile: kSubW x kSubH, a pixel
constexpr int kSubH = 4;     // a lane
constexpr int kStride = 5;   // float4s a candidate in shared memory
constexpr float kBigZ = 1e10f;
constexpr float kNoFace = 1073741824.0f;  // 2^30

__device__ __forceinline__ float affine(float c, float x, float y, float gx,
                                        float gy) {
  return __fmaf_rn(y, gy, __fmaf_rn(x, gx, c));
}

// The row's value at the corner of [x0, x0 + kSubW - 1] x [y0, y0 + kSubH - 1]
// where it is largest (see the header).
__device__ __forceinline__ float corner(float c, float x, float y, float x0,
                                        float y0) {
  return affine(c, x, y, x >= 0.f ? x0 + (kSubW - 1) : x0,
                y >= 0.f ? y0 + (kSubH - 1) : y0);
}

// kUV: the slab has 19 rows (b0 b1 b2 z u v, each (c, x, y), then the face
// id) and the outputs are (pix_to_face, u, v); otherwise 13 rows (no u, v)
// and the outputs are (pix_to_face, zbuf), with out1 unused. A candidate's
// rows keep their order in shared memory.
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
  static_assert(kTile % kQuad == 0 && kCoeffs <= 4 * kStride
                && (kQuad / kSubW) * (kQuad / kSubH) == kThreads / 32,
                "a quad is one sub-tile a warp");
  __shared__ float4 sh4[kChunk * kStride];
  const float* sh = reinterpret_cast<const float*>(sh4);
  const int quads_x = width / kQuad;
  const int qx = blockIdx.x % quads_x;
  const int qy = blockIdx.x / quads_x;
  const int t = (qy * kQuad / kTile) * tiles_x + qx * kQuad / kTile;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int start = starts[b * (tiles + 1) + t];
  const int end = starts[b * (tiles + 1) + t + 1];
  const float* seg = slab + (int64_t)b * kCoeffs * entries;

  // the warp's sub-tile (first pixel x0, y0) and the lane's pixel
  const float x0 = (float)(qx * kQuad + (warp % (kQuad / kSubW)) * kSubW);
  const float y0 = (float)(qy * kQuad + (warp / (kQuad / kSubW)) * kSubH);
  const float gx = x0 + (float)(lane % kSubW);
  const float gy = y0 + (float)(lane / kSubW);
  float zb = kBigZ, fb = kNoFace, ub = 0.f, vb = 0.f;

  for (int base = start; base < end; base += kChunk) {
    const int n = min(kChunk, end - base);
    if (tid < n) {
      float r[4 * kStride];
#pragma unroll
      for (int j = 0; j < 4 * kStride; ++j)
        r[j] = j < kCoeffs ? seg[(int64_t)j * entries + base + tid] : 0.f;
#pragma unroll
      for (int m = 0; m < kStride; ++m)
        sh4[tid * kStride + m] = make_float4(r[4 * m], r[4 * m + 1],
                                             r[4 * m + 2], r[4 * m + 3]);
    }
    __syncthreads();
    for (int g = 0; g < n; g += 32) {
      // coarse: candidate g + lane against the warp's sub-tile
      const int i = g + lane;
      bool keep = false;
      if (i < n) {
        const float4 e0 = sh4[i * kStride], e1 = sh4[i * kStride + 1];
        const float4 e2 = sh4[i * kStride + 2];
        keep = (corner(e0.x, e0.y, e0.z, x0, y0) >= 0.f)   // NaN, -inf fail
            & (corner(e0.w, e1.x, e1.y, x0, y0) >= 0.f)
            & (corner(e1.z, e1.w, e2.x, x0, y0) >= 0.f);
      }
      // fine: the survivors, in the per-pixel arithmetic of the plain version
      for (unsigned todo = __ballot_sync(0xffffffffu, keep); todo;
           todo &= todo - 1) {
        const int k = g + __ffs(todo) - 1;
        const float4 e0 = sh4[k * kStride], e1 = sh4[k * kStride + 1];
        const float4 e2 = sh4[k * kStride + 2];
        const float w0 = affine(e0.x, e0.y, e0.z, gx, gy);
        const float w1 = affine(e0.w, e1.x, e1.y, gx, gy);
        const float w2 = affine(e1.z, e1.w, e2.x, gx, gy);
        if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f) {
          const float z = affine(e2.y, e2.z, e2.w, gx, gy);
          const float fid = sh[k * 4 * kStride + kFid];
          if (z < zb || (z == zb && fid < fb)) {
            zb = z;
            fb = fid;
            if constexpr (kUV) {
              const float* p = sh + k * 4 * kStride;
              ub = affine(p[12], p[13], p[14], gx, gy);
              vb = affine(p[15], p[16], p[17], gx, gy);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  const int64_t o = ((int64_t)b * height + (int)gy) * width + (int)gx;
  const bool hit = fb < kNoFace;
  pix_to_face[o] = hit ? (int32_t)fb : -1;
  if constexpr (kUV) {
    out0[o] = hit ? ub : 0.f;
    out1[o] = hit ? vb : 0.f;
  } else {
    out0[o] = zb;  // kBigZ where no face won
  }
}

template <int kTile, bool kUV>
int launch(const void* slab, const void* starts, void* pix_to_face,
           void* out0, void* out1, int batch, int entries, int height,
           int width, void* stream) {
  const int tiles_x = width / kTile;
  const int tiles = tiles_x * (height / kTile);
  dim3 grid((width / kQuad) * (height / kQuad), batch);
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
