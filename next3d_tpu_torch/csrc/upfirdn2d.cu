// FIR resampling for Hopper (sm_90a): pad -> zero-insert upsample -> FIR
// filter -> downsample, in one pass.
//
// The port's own kernel; it replaces no TPU kernel (the JAX package leaves
// the filter to XLA). Semantics are ops/upfirdn2d.py upfirdn2d_plain's:
// out_full[Y, X] = sum_{i, j} xp[Y + i, X + j] * g[i, j], where xp is x with
// up - 1 zeros after each sample, padded by (padx0, pady0) in front (a
// negative pad crops), g is the filter flipped unless flip_filter, times
// gain, and the output keeps every down-th row and column of out_full.
//
// What bounds it on the H100: bytes. A 4x4 filter at up 1 does 16 MACs an
// output against 8 bytes moved, far below the card's ridge point, so the
// design reads the input once and writes only the kept outputs:
// - Polyphase: an output reads only the taps that land on real samples
//   (4 of 16 at up 2), so the zero-inserted map is never built.
// - Strided: at down > 1 only the kept outputs are computed.
// - A block stages its input tile and halo in shared memory, converted
//   from the input's dtype once; taps add in float32.
// Two layouts, input and output in the same one: the wrapper picks the
// layout the plain route gives the result (NHWC for a channels-last input
// at up 1, else NCHW), so the convolutions after it see what they saw:
// - NCHW: a block is a 32-wide tile of one (image, channel) plane, a lane
//   a column and a thread ROWS rows of it.
// - NHWC (channels last): a block is a tile of pixels times 8 lanes of
//   VEC channels each (16-byte loads and stores: 4 float32 or 8 bf16), a
//   thread a column of ROWS rows of its lane's channels.
// Instances: a 4x4 filter at (up, down) = (1, 1), (2, 1) and (1, 2) have
// their taps, phases and tile fixed at compile time; instance 0 takes any
// filter size, integer up and down per axis and padding at run time (a
// separable 1-D filter is two of its passes, (1, taps) then (taps, 1)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                    // NHWC: lanes along channels
constexpr int kPixels = kThreads / kLanes;   // NHWC: pixel threads a block
constexpr size_t kMaxShared = 200 * 1024;
constexpr int kLoadBatch = 4;   // loads a thread has in flight when staging
// blocks an SM holds, for the register cap: NCHW 4 at 8 rows a thread,
// else 8; NHWC 4 (its tile of 128-byte pixels is most of the limit)
constexpr int kNhwcBlocks = 4;

struct Args {
  const void* x;
  void* y;
  const float* f;
  int N, C, H, W, OH, OW;
  int upx, upy, downx, downy, padx0, pady0;
  int fw, fh, fsx, fsy, flip;
  float gain;
  // the block's output tile, its input tile (an upper bound) and the
  // tiles of the grid along x and y
  int tile_ow, tile_oh, in_tw, in_th, tiles_x, tiles_y;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return (a >= 0 ? a : a - b + 1) / b;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// an input tile's rows (or columns) for `outs` outputs of a fixed
// instance (0 for instance 0, whose tile the host sizes)
template <int U, int D, int K>
__host__ __device__ constexpr int span(int outs) {
  return K ? ((outs - 1) * D + K - 1) / U + 1 : 0;
}

// the correlation taps g[i * fw + j], flipped unless flip and scaled by
// gain, from the filter's device buffer
__device__ void load_taps(const Args& a, float* g, int fh, int fw) {
  for (int t = threadIdx.x; t < fh * fw; t += blockDim.x) {
    int i = t / fw, j = t - (t / fw) * fw;
    if (!a.flip) {
      i = fh - 1 - i;
      j = fw - 1 - j;
    }
    g[t] = a.f[i * a.fsy + j * a.fsx] * a.gain;
  }
}

// one axis of an output: its first input row (or column) and first tap
struct Phase {
  int first;  // input index of the first real tap
  int tap;    // the tap that lands on it
};

__device__ __forceinline__ Phase phase(int o, int down, int pad, int up) {
  const int e = o * down - pad;
  const int r = floor_div(e + up - 1, up);
  return {r, r * up - e};
}

// taps an output reads along an axis: fixed when K and U are, else the
// taps from `tap` on in steps of `up`
template <int K, int U>
__device__ __forceinline__ int taps(int size, int tap, int up) {
  static_assert(!(K && U) || K % U == 0, "a fixed filter spans whole phases");
  if (K && U) return K / U;
  return (size - tap + up - 1) / up;
}

// Stage the input tile of rows r0.., columns c0.. (zeros outside the
// image) in shared memory: element t of the tile, t = r * in_tw + c, at
// tile[t * stride]. A thread issues kLoadBatch loads before it
// stores any, so that many are in flight.
template <typename E, typename Load>
__device__ __forceinline__ void stage(E* tile, int stride, int first,
                                      int step, const Args& a, int in_th,
                                      int in_tw, int r0, int c0, Load load) {
  const int total = in_th * in_tw;
  for (int t0 = first; t0 < total; t0 += kLoadBatch * step) {
    E v[kLoadBatch];
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      const int t = t0 + b * step;
      const int r = t / in_tw, c = t - (t / in_tw) * in_tw;
      const int ir = r0 + r, ic = c0 + c;
      v[b] = load(t < total && ir >= 0 && ir < a.H && ic >= 0 && ic < a.W,
                  (long long)ir * a.W + ic);
    }
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      const int t = t0 + b * step;
      if (t < total) tile[t * stride] = v[b];
    }
  }
}

// ROWS outputs of one column, rows oy .. oy + ROWS - 1 (acc[k]), of VEC
// channels, from the staged tile; `at(r, c)` is the tile's element at tile
// row r and column c as VEC floats.
// - At up 1 with a fixed filter (up1, down2) the taps and phases are
//   compile-time: the thread walks the (ROWS - 1) * D + K tile rows its
//   outputs read and adds each row, read once, into every output that
//   takes it.
// - Otherwise each output adds its own taps: those of its phase.
template <int VEC, int U, int D, int K, int ROWS, typename At>
__device__ __forceinline__ void column(float (&acc)[ROWS][VEC], At at,
                                       const Args& a, const float* g,
                                       int oy, int r0, Phase px, int c0) {
#pragma unroll
  for (int k = 0; k < ROWS; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;
  if constexpr (U == 1 && K > 0) {
    const int row0 = oy * D - a.pady0 - r0, col0 = px.first - c0;
#pragma unroll
    for (int r = 0; r < (ROWS - 1) * D + K; ++r) {
      float v[K][VEC];
#pragma unroll
      for (int j = 0; j < K; ++j) at(row0 + r, col0 + j, v[j]);
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int i = r - k * D;
        if (i < 0 || i >= K) continue;
#pragma unroll
        for (int j = 0; j < K; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[k][e] += v[j][e] * g[i * K + j];
      }
    }
  } else {
    const int fh = K ? K : a.fh, fw = K ? K : a.fw;
    const int upx = U ? U : a.upx, upy = U ? U : a.upy;
    const int dy = D ? D : a.downy;
    const int nx = taps<K, U>(fw, px.tap, upx);
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const Phase py = phase(oy + k, dy, a.pady0, upy);
      const int ny = taps<K, U>(fh, py.tap, upy);
#pragma unroll
      for (int ki = 0; ki < ny; ++ki) {
        const float* gi = g + (py.tap + ki * upy) * fw + px.tap;
#pragma unroll
        for (int kj = 0; kj < nx; ++kj) {
          float v[VEC];
          at(py.first - r0 + ki, px.first - c0 + kj, v);
          const float w = gi[kj * upx];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[k][e] += v[e] * w;
        }
      }
    }
  }
}

template <typename T, int U, int D, int K, int ROWS>
__global__ void __launch_bounds__(kThreads, ROWS >= 8 ? 4 : 8)
upfirdn2d_nchw_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int fh = K ? K : a.fh, fw = K ? K : a.fw;
  const int upx = U ? U : a.upx, upy = U ? U : a.upy;
  const int dx = D ? D : a.downx, dy = D ? D : a.downy;
  float* g = smem;
  float* tile = smem + ((fh * fw + 3) & ~3);
  load_taps(a, g, fh, fw);

  constexpr int TW = 32, TH = (kThreads / 32) * ROWS;
  const int in_tw = K ? span<U, D, K>(TW) : a.in_tw;
  const int in_th = K ? span<U, D, K>(TH) : a.in_th;
  const int by = blockIdx.x / a.tiles_x, bx = blockIdx.x - by * a.tiles_x;
  const int oy0 = by * TH, ox0 = bx * TW;
  const int r0 = phase(oy0, dy, a.pady0, upy).first;
  const int c0 = phase(ox0, dx, a.padx0, upx).first;
  const int ox = ox0 + (threadIdx.x & 31);
  const int oy = oy0 + (threadIdx.x >> 5) * ROWS;
  const Phase px = phase(ox, dx, a.padx0, upx);
  const long long planes = (long long)a.N * a.C;
  auto at = [tile, in_tw](int r, int c, float (&v)[1]) {
    v[0] = tile[r * in_tw + c];
  };

  for (long long plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const T* x = static_cast<const T*>(a.x) + plane * a.H * a.W;
    __syncthreads();  // the previous plane's reads of the tile are done
    stage(tile, 1, threadIdx.x, kThreads, a, in_th, in_tw, r0, c0,
          [x](bool in, long long i) { return in ? to_float(x[i]) : 0.f; });
    __syncthreads();
    if (ox >= a.OW || oy >= a.OH) continue;
    float acc[ROWS][1];
    column<1, U, D, K, ROWS>(acc, at, a, g, oy, r0, px, c0);
    T* y = static_cast<T*>(a.y) + plane * a.OH * a.OW;
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      if (oy + k < a.OH)
        y[(long long)(oy + k) * a.OW + ox] = from_float<T>(acc[k][0]);
  }
}

template <typename T, int VEC, int U, int D, int K, int TW, int ROWS>
__global__ void __launch_bounds__(kThreads, kNhwcBlocks)
upfirdn2d_nhwc_kernel(Args a) {
  using P = Pack<T, VEC>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int fh = K ? K : a.fh, fw = K ? K : a.fw;
  const int upx = U ? U : a.upx, upy = U ? U : a.upy;
  const int dx = D ? D : a.downx, dy = D ? D : a.downy;
  float* g = smem;
  P* tile = reinterpret_cast<P*>(smem + ((fh * fw + 3) & ~3));
  load_taps(a, g, fh, fw);

  constexpr int TH = (kPixels / TW) * ROWS;
  const int in_tw = K ? span<U, D, K>(TW) : a.in_tw;
  const int in_th = K ? span<U, D, K>(TH) : a.in_th;
  const int by = blockIdx.x / a.tiles_x, bx = blockIdx.x - by * a.tiles_x;
  const int oy0 = by * TH, ox0 = bx * TW;
  const int r0 = phase(oy0, dy, a.pady0, upy).first;
  const int c0 = phase(ox0, dx, a.padx0, upx).first;
  const int lane = threadIdx.x % kLanes, p = threadIdx.x / kLanes;
  const int ox = ox0 + p % TW;
  const int oy = oy0 + (p / TW) * ROWS;
  const Phase px = phase(ox, dx, a.padx0, upx);
  const int blocks_c = (a.C + kLanes * VEC - 1) / (kLanes * VEC);
  const long long jobs = (long long)a.N * blocks_c;
  const P* mine = tile + lane;
  auto at = [mine, in_tw](int r, int c, float (&v)[VEC]) {
    const P t = mine[(r * in_tw + c) * kLanes];
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = to_float(t.v[e]);
  };

  for (long long job = blockIdx.y; job < jobs; job += gridDim.y) {
    const long long n = job / blocks_c;
    const int c = (int)(job - n * blocks_c) * kLanes * VEC + lane * VEC;
    const bool live = c < a.C;  // VEC > 1 only where C % VEC == 0
    const T* x = static_cast<const T*>(a.x) + n * a.H * a.W * a.C + c;
    const int C = a.C;
    __syncthreads();
    stage(tile + lane, kLanes, p, kPixels, a, in_th, in_tw, r0, c0,
          [x, C, live](bool in, long long i) {
            P v;
            if (in && live) {
              v = *reinterpret_cast<const P*>(x + i * C);
            } else {
#pragma unroll
              for (int e = 0; e < VEC; ++e) v.v[e] = from_float<T>(0.f);
            }
            return v;
          });
    __syncthreads();
    if (!live || ox >= a.OW || oy >= a.OH) continue;
    float acc[ROWS][VEC];
    column<VEC, U, D, K, ROWS>(acc, at, a, g, oy, r0, px, c0);
    T* y = static_cast<T*>(a.y) + n * a.OH * a.OW * a.C + c;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      if (oy + k >= a.OH) break;
      P out;
#pragma unroll
      for (int e = 0; e < VEC; ++e) out.v[e] = from_float<T>(acc[k][e]);
      *reinterpret_cast<P*>(y + ((long long)(oy + k) * a.OW + ox) * a.C) =
          out;
    }
  }
}

// the input tile of an output tile (an upper bound over tiles) and the
// grid of tiles over the output
void geometry(Args& a, int tile_ow, int tile_oh) {
  a.tile_ow = tile_ow;
  a.tile_oh = tile_oh;
  a.in_tw = ((tile_ow - 1) * a.downx + a.fw - 1) / a.upx + 1;
  a.in_th = ((tile_oh - 1) * a.downy + a.fh - 1) / a.upy + 1;
  a.tiles_x = (a.OW + tile_ow - 1) / tile_ow;
  a.tiles_y = (a.OH + tile_oh - 1) / tile_oh;
}

size_t taps_bytes(const Args& a) {
  return ((a.fh * a.fw + 3) & ~3) * sizeof(float);
}

template <typename Kernel>
cudaError_t run(Kernel kernel, const Args& a, long long jobs,
                size_t tile_bytes, cudaStream_t stream) {
  const size_t shared = taps_bytes(a) + tile_bytes;
  if (shared > kMaxShared) return cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return err;
  }
  const long long tiles = (long long)a.tiles_x * a.tiles_y;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)(jobs < 65535 ? jobs : 65535));
  kernel<<<grid, kThreads, shared, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int U, int D, int K, int ROWS>
cudaError_t nchw(Args a, cudaStream_t stream) {
  constexpr int TW = 32, TH = (kThreads / 32) * ROWS;
  // an output shorter than a tall tile takes 16-row tiles
  if (ROWS > 2 && a.OH < TH) return nchw<T, U, D, K, 2>(a, stream);
  geometry(a, TW, TH);
  return run(upfirdn2d_nchw_kernel<T, U, D, K, ROWS>, a, (long long)a.N * a.C,
             (size_t)a.in_th * a.in_tw * sizeof(float), stream);
}

template <typename T, int VEC, int U, int D, int K, int TW, int ROWS>
cudaError_t nhwc(Args a, cudaStream_t stream) {
  geometry(a, TW, (kPixels / TW) * ROWS);
  const int blocks_c = (a.C + kLanes * VEC - 1) / (kLanes * VEC);
  return run(upfirdn2d_nhwc_kernel<T, VEC, U, D, K, TW, ROWS>, a,
             (long long)a.N * blocks_c,
             (size_t)a.in_th * a.in_tw * kLanes * sizeof(Pack<T, VEC>),
             stream);
}

// an instance's tile: (NCHW rows a thread, NHWC tile width, NHWC rows a
// thread); an NCHW tile is 32 outputs wide, an NHWC tile about 19 x 19
// input pixels of 128 bytes at up 1 (chosen by timing, PERF.md)
template <typename T, int VEC, int U, int D, int K, int NCHW_ROWS,
          int NHWC_W, int NHWC_ROWS>
cudaError_t instance(const Args& a, int channels_last, cudaStream_t stream) {
  if (!channels_last) return nchw<T, U, D, K, NCHW_ROWS>(a, stream);
  return nhwc<T, VEC, U, D, K, NHWC_W, NHWC_ROWS>(a, stream);
}

template <typename T, int VEC>
cudaError_t dispatch(const Args& a, int channels_last, int which,
                     cudaStream_t stream) {
  const bool k4 = a.fw == 4 && a.fh == 4;
  switch (which) {
    case 0:
      return instance<T, VEC, 0, 0, 0, 4, 8, 1>(a, channels_last, stream);
    case 1:
      if (!k4 || a.upx != 1 || a.upy != 1 || a.downx != 1 || a.downy != 1)
        return cudaErrorInvalidValue;
      return instance<T, VEC, 1, 1, 4, 8, 16, 8>(a, channels_last, stream);
    case 2:
      if (!k4 || a.upx != 2 || a.upy != 2 || a.downx != 1 || a.downy != 1)
        return cudaErrorInvalidValue;
      return instance<T, VEC, 2, 1, 4, 8, 16, 8>(a, channels_last, stream);
    case 3:
      if (!k4 || a.upx != 1 || a.upy != 1 || a.downx != 2 || a.downy != 2)
        return cudaErrorInvalidValue;
      return instance<T, VEC, 1, 2, 4, 4, 8, 2>(a, channels_last, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x (N, C, H, W) in NCHW or, with channels_last, NHWC order; y (N, C, OH,
// OW) in the same order; f the filter's float32 taps, tap (i, j) at
// f[i * fsy + j * fsx]. bf16: the tensors are bfloat16, else float32. vec:
// NHWC only, 16-byte channel vectors (C a multiple of 16 bytes' elements
// and both pointers 16-byte aligned). instance: 0 any, 1-3 the 4x4 filter
// at (up, down) (1, 1), (2, 1), (1, 2) on both axes.
extern "C" int upfirdn2d(const void* x, void* y, const void* f, int bf16,
                         int channels_last, int vec, int which, int N, int C,
                         int H, int W, int OH, int OW, int upx, int upy,
                         int downx, int downy, int padx0, int pady0, int fw,
                         int fh, int fsx, int fsy, int flip, float gain,
                         void* stream) {
  if ((long long)N * C * OH * OW == 0) return 0;
  Args a;
  a.x = x;
  a.y = y;
  a.f = static_cast<const float*>(f);
  a.N = N; a.C = C; a.H = H; a.W = W; a.OH = OH; a.OW = OW;
  a.upx = upx; a.upy = upy; a.downx = downx; a.downy = downy;
  a.padx0 = padx0; a.pady0 = pady0;
  a.fw = fw; a.fh = fh; a.fsx = fsx; a.fsy = fsy; a.flip = flip;
  a.gain = gain;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return vec ? (int)dispatch<__nv_bfloat16, 8>(a, channels_last, which, s)
               : (int)dispatch<__nv_bfloat16, 1>(a, channels_last, which, s);
  }
  return vec ? (int)dispatch<float, 4>(a, channels_last, which, s)
             : (int)dispatch<float, 1>(a, channels_last, which, s);
}

extern "C" const char* upfirdn2d_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
