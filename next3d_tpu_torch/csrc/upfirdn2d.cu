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
// their taps, phases and tile fixed at compile time (upfirdn2d_nchw_kernel
// and upfirdn2d_nhwc_kernel below, and their helpers, serve them and the
// NHWC instance 0); instance 0 takes any filter size, integer up and down
// per axis and padding at run time. In NHWC order a separable 1-D filter
// is two of its passes, (1, taps) then (taps, 1).
//
// Instance 0 in NCHW order (namespace any_nchw, StyleGAN3's filtered lrelu,
// ADA's pipe, the equivariance metrics) is built for this card apart:
// - A separable filter is one launch: the x pass of the staged tile goes
//   into a shared-memory map (input rows x output columns), the y pass
//   reads it; the x pass's map never reaches device memory.
// - Outputs are grouped by phase: along an axis, outputs up / gcd(up, down)
//   apart share their taps, so a thread's outputs of one phase share one
//   segment of at most kTaps taps, held in registers, and the block finds
//   each phase's taps once, not per output.
// - Within one phase, an output's inputs are every s-th input of the tile
//   (s = down / gcd(up, down)); each thread computes a block of outputs of
//   one phase (3 along x; 4 along y in a 2-D pass, 8 in a y pass), loads
//   each staged value once and adds it into every output of its block
//   that takes it.
// - The copy engine stages the input tile (a bulk copy a row, completing
//   on an mbarrier): no thread waits on its own loads, so the other blocks
//   of an SM compute while one waits.
// What bounds its calls on the H100: at up 2 and up 4 the bytes (an up-4
// call writes 16 outputs an input, 6 + 6 taps each); at the 12x12 radial
// down-filter the bytes and the float32 FMAs nearly alike (144 an output:
// at SG3-R's layer 10, 3.0 ms of FMA against 4.2 of bytes), with a shared-
// memory load issued for about 6 FMAs. The tile is fetched as the rows lie
// in memory, not split by column phase: at down 2 a warp's strided reads
// meet 2-way bank conflicts, but half-warps walking the planes in opposite
// orders, which removes them, left layer 10's down call at 7.9 ms.
// The fixed instances above are unchanged by this design.

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

// ------------------------------------------- instance 0 (any), NCHW order
// The outputs along an axis fall into S = up / gcd(up, down) phases:
// outputs S apart take the same taps and read inputs s = down / gcd(up,
// down) apart. Seen as s planes (the inputs of index b mod s, b < s), a
// phase's consecutive outputs read consecutive inputs of a plane: every
// pass becomes step-1 correlations over segments of kTaps taps each (a
// phase's taps that fall in one plane, kTaps at a time, the last
// zero-padded). A thread holds a segment's taps in registers and walks the
// fetched rows its block of outputs reads, loading each value once for
// every output that takes it. The copy engine fetches the block's input
// tile (a bulk copy a row, on an mbarrier), so no thread waits on a load
// it issued and the other blocks of the SM compute meanwhile.
namespace any_nchw {
constexpr int kTaps = 6;   // taps of a segment
constexpr int kRows = 8;   // outputs a thread along y in the y pass
constexpr int kRows2 = 4;  // along y in the 2-D pass
// outputs a thread along x (2-D and x pass): odd, so that lanes kCols
// words apart read distinct banks
constexpr int kCols = 3;
// Blocks an SM and the shared memory a tile aims at (chosen by timing,
// PERF.md): the 2-D pass 3 blocks of 75 KB, the separable one 4 of 56 KB
constexpr int kBlocks2 = 3, kBlocksSep = 4;
constexpr size_t kTarget2 = 75 * 1024, kTargetSep = 56 * 1024;
// a block's dynamic shared memory (the mbarrier is static)
constexpr size_t kMost = 227 * 1024 - 64;

__host__ __device__ __forceinline__ int div_floor(int a, int b) {
  return (a >= 0 ? a : a - b + 1) / b;
}

__host__ __device__ __forceinline__ int mod_floor(int a, int b) {
  return a - div_floor(a, b) * b;
}

// one axis of a call and of its tiles
struct Axis {
  int up, down, pad, taps;  // pad: in front, on the upsampled axis
  int phases, step;         // S and s
  int per_plane, segs;      // segments a (phase, plane); a phase: step * per_plane
  int first;                // input of tile 0's first read (over its phases)
  int groups;               // threads a phase: lanes (x) or row jobs (y)
  int span;                 // a phase's outputs a tile: groups * kCols|kRows
  int tile;                 // outputs a tile: phases * span
  int plane;                // a plane's length; the input tile is step * plane
  int tiles;                // tiles over the output
};

// a phase's first input (for the tile's first output of that phase), the
// tap that lands on it and the phase's taps (from it on, up apart)
struct AxisPhase {
  int first, tap, taps;
};

__host__ __device__ __forceinline__ AxisPhase axis_phase(const Axis& x,
                                                         int ph) {
  const int e = ph * x.down - x.pad;
  const int first = div_floor(e + x.up - 1, x.up);
  const int tap = first * x.up - e;
  return {first, tap, tap < x.taps ? (x.taps - tap + x.up - 1) / x.up : 0};
}

// segment j of phase ph: its plane, its first input in the plane relative
// to the tile (for the phase's first output), and its taps tap + c * stride,
// c < kTaps, of which those below the axis's taps are real
struct Segment {
  int plane, off, tap, stride;
};

__host__ __device__ __forceinline__ Segment segment(const Axis& x, int ph,
                                                    int j) {
  const AxisPhase p = axis_phase(x, ph);
  const int plane = j / x.per_plane, q = j - plane * x.per_plane;
  const int d = p.first - x.first;
  const int k = mod_floor(plane - d, x.step);  // the phase's first tap here
  return {plane, (d + k - plane) / x.step + q * kTaps,
          p.tap + x.up * (k + q * kTaps * x.step), x.up * x.step};
}

struct AnyArgs {
  const void* x;
  void* y;
  const float* f;
  int N, C, H, W, OH, OW;
  int fw, fh, fsx, fsy, flip;
  float gain;
  Axis ax, ay;
  int rows;          // rows of the fetched tile: ay.step * ay.plane
  int cols;          // its columns: ax.step * ax.plane
  int pitch;         // elements a fetched row: 16-byte words
  int mid_floats;    // separable: floats between planes of the x pass's map
  int taps_floats;   // floats of the arranged taps (a multiple of 4)
  int raw_at;        // floats before the fetched tile
};

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// an axis's phases, segments, planes and tiles, for `per` outputs a thread
// and `groups` threads a phase
void axis_geometry(Axis& x, int up, int down, int pad, int taps, int out,
                   int per, int groups) {
  x.up = up;
  x.down = down;
  x.pad = pad;
  x.taps = taps;
  const int g = gcd(up, down);
  x.phases = up / g;
  x.step = down / g;
  x.first = axis_phase(x, 0).first;
  for (int ph = 1; ph < x.phases; ++ph)
    if (axis_phase(x, ph).first < x.first) x.first = axis_phase(x, ph).first;
  int most = 1, reach = 0;
  for (int ph = 0; ph < x.phases; ++ph) {
    const AxisPhase p = axis_phase(x, ph);
    const int d = p.first - x.first;
    for (int b = 0; b < x.step; ++b) {
      const int k = mod_floor(b - d, x.step);
      const int n = p.taps > k ? (p.taps - k + x.step - 1) / x.step : 0;
      if ((n + kTaps - 1) / kTaps > most) most = (n + kTaps - 1) / kTaps;
      if ((d + k - b) / x.step > reach) reach = (d + k - b) / x.step;
    }
  }
  x.per_plane = most;
  x.segs = x.step * most;
  x.groups = groups;
  x.span = per * groups;
  x.tile = x.phases * x.span;
  x.plane = reach + (most - 1) * kTaps + x.span + kTaps - 1;
  x.tiles = (out + x.tile - 1) / x.tile;
}

// the layout of the block's shared memory: the arranged taps, the segment
// table, for a separable filter the x pass's map, and the fetched tile in
// the input's dtype (a row 16-byte words from the one that holds the
// tile's first column); returns its bytes
size_t layout(AnyArgs& a, int sep, int elem) {
  const Axis &ax = a.ax, &ay = a.ay;
  const int nx = ax.phases * ax.segs, ny = ay.phases * ay.segs;
  a.taps_floats = sep ? ((nx + ny) * kTaps + 3) & ~3
                      : nx * ny * kTaps * kTaps;
  const int table = ((nx + ny) * 2 + 3) & ~3;
  a.mid_floats = sep ? (ay.plane * ax.tile + 3) & ~3 : 0;
  a.raw_at = a.taps_floats + table + ay.step * a.mid_floats;
  a.rows = ay.step * ay.plane;
  a.cols = ax.step * ax.plane;
  const int vec = 16 / elem;
  a.pitch = vec * ((a.cols + vec - 1) / vec + 1);
  return sizeof(float) * (size_t)a.raw_at + (size_t)elem * a.pitch * a.rows;
}

// elements of p past the 16-byte word that holds it
template <typename T>
__device__ __forceinline__ int misalign(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

// Fetch rows r0 .. r0 + a.rows - 1 of the plane x into `raw`, unconverted,
// by the copy engine (a bulk copy a row, issued by warp 0, completing on
// the mbarrier `bar`): raw row r's 16-byte words start with the one that
// holds column c0; only the words that hold columns of the image are
// copied (they lie inside the tensor's allocation), the rest is left.
template <typename T>
__device__ __forceinline__ void fetch(T* raw, const T* x, const AnyArgs& a,
                                      int r0, int c0, unsigned bar) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, rows = a.rows;
  const int lo = c0 > 0 ? c0 : 0;
  const int hi = c0 + a.cols < a.W ? c0 + a.cols : a.W;
  // row r's words j0 .. j1 - 1 from `src`, or none
  auto words = [&](int r, int& j0, const T*& src) {
    const int ir = r0 + r;
    if (ir < 0 || ir >= a.H || lo >= hi) return 0;
    const T* at = x + (long long)ir * a.W + c0;
    const int first = c0 - misalign(at);
    j0 = (lo - first) / V;
    src = at - misalign(at) + j0 * V;
    return (hi - 1 - first) / V + 1 - j0;
  };
  int total = 0, j0;
  const T* src;
  for (int r = lane; r < rows; r += 32) total += 16 * words(r, j0, src);
#pragma unroll
  for (int o = 16; o; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
  if (lane == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(total) : "memory");
  __syncwarp();
  for (int r = lane; r < rows; r += 32) {
    const int n = words(r, j0, src);
    if (!n) continue;
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(
        raw + r * a.pitch + j0 * V));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(d), "l"(src), "r"(16 * n),
        "r"(bar) : "memory");
  }
}

// wait for the fetch of the mbarrier's phase `parity`
__device__ __forceinline__ void wait_fetched(unsigned bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nwait:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// Zeros in the fetched rows of the image where their columns are not: the
// copied words at a row's ends hold the row's neighbours, and the word
// beyond each end may hold a plane's fetched before with another
// alignment. Rows outside the image keep the zeros the block wrote first.
template <typename T>
__device__ __forceinline__ void edges(T* raw, const T* x, const AnyArgs& a,
                                      int r0, int c0) {
  constexpr int V = 16 / sizeof(T);
  const int lo = c0 > 0 ? c0 : 0;
  const int hi = c0 + a.cols < a.W ? c0 + a.cols : a.W;
  if (lo >= hi || (c0 >= 0 && c0 + a.cols <= a.W)) return;
  for (int r = threadIdx.x; r < a.rows; r += blockDim.x) {
    const int ir = r0 + r;
    if (ir < 0 || ir >= a.H) continue;
    const int first = c0 - misalign(x + (long long)ir * a.W + c0);
    const int j0 = (lo - first) / V, j1 = (hi - 1 - first) / V + 1;
    T* row = raw + r * a.pitch;
#pragma unroll
    for (int e = 0; e < 2 * V; ++e) {
      const int k0 = (j0 - 1) * V + e, k1 = (j1 - 1) * V + e;
      if (k0 >= 0 && first + k0 < 0) row[k0] = from_float<T>(0.f);
      if (k1 < a.pitch && first + k1 >= a.W) row[k1] = from_float<T>(0.f);
    }
  }
}

// The taps by segment, flipped unless flip, with the gain: a 2-D filter's
// block of kTaps x kTaps for each (y segment, x segment) pair; a separable
// filter's x segments, then its y segments with the gain. Then the table
// of each segment's plane and offset, x's then y's.
template <int SEP>
__device__ void arrange(const AnyArgs& a, float* taps, int2* table) {
  const Axis &ax = a.ax, &ay = a.ay;
  const int nx = ax.phases * ax.segs, ny = ay.phases * ay.segs;
  if (SEP) {
    for (int t = threadIdx.x; t < (nx + ny) * kTaps; t += blockDim.x) {
      const int s = t / kTaps, c = t - s * kTaps;
      const bool along_x = s < nx;
      const Axis& x = along_x ? ax : ay;
      const int sj = along_x ? s : s - nx;
      const int ph = sj / x.segs;
      const Segment g = segment(x, ph, sj - ph * x.segs);
      const int k = g.tap + c * g.stride;
      float v = 0.f;
      if (k < x.taps) {
        const int i = a.flip ? k : x.taps - 1 - k;
        v = along_x ? a.f[i * a.fsx] : a.f[i * a.fsy] * a.gain;
      }
      taps[t] = v;
    }
  } else {
    constexpr int kBlock = kTaps * kTaps;
    for (int t = threadIdx.x; t < nx * ny * kBlock; t += blockDim.x) {
      const int b = t / kBlock, e = t - b * kBlock;
      const int sy = b / nx, sx = b - sy * nx;
      const int phy = sy / ay.segs, phx = sx / ax.segs;
      const Segment gy = segment(ay, phy, sy - phy * ay.segs);
      const Segment gx = segment(ax, phx, sx - phx * ax.segs);
      int i = gy.tap + (e / kTaps) * gy.stride;
      int j = gx.tap + (e % kTaps) * gx.stride;
      float v = 0.f;
      if (i < a.fh && j < a.fw) {
        if (!a.flip) {
          i = a.fh - 1 - i;
          j = a.fw - 1 - j;
        }
        v = a.f[i * a.fsy + j * a.fsx] * a.gain;
      }
      taps[t] = v;
    }
  }
  for (int t = threadIdx.x; t < nx + ny; t += blockDim.x) {
    const Axis& x = t < nx ? ax : ay;
    const int sj = t < nx ? t : t - nx;
    const int ph = sj / x.segs;
    const Segment g = segment(x, ph, sj - ph * x.segs);
    table[t] = make_int2(g.plane, g.off);
  }
}

// Where the fetched rows start: row r's first element is the tile's column
// -((m0 + r * wr) & (V - 1)), V elements a 16-byte word (a plane's rows
// shift when a row's bytes are no multiple of 16).
struct Shift {
  int m0, wr;
};

template <typename T>
__device__ __forceinline__ const T* tile_row(const T* raw, int pitch,
                                             Shift sh, int r) {
  return raw + r * pitch + ((sh.m0 + r * sh.wr) & (16 / sizeof(T) - 1));
}

// RY x RX outputs of one phase from the fetched tile: acc[k][m] +=
// sum_{i, j} t(row + (k + i) * rstep, col + (m + j) * cstep) * g[i][j],
// t(r, c) the tile's element at row r, column c. The thread walks the
// RY + kTaps - 1 rows; each value, loaded once, goes to every output that
// takes it.
template <int RY, int RX, typename T>
__device__ __forceinline__ void window(float (&acc)[RY][RX], const T* raw,
                                       int pitch, Shift sh, int row,
                                       int rstep, int col, int cstep,
                                       const float (&g)[kTaps * kTaps]) {
#pragma unroll
  for (int r = 0; r < RY + kTaps - 1; ++r) {
    const T* src = tile_row(raw, pitch, sh, row + r * rstep) + col;
    float v[RX + kTaps - 1];
#pragma unroll
    for (int c = 0; c < RX + kTaps - 1; ++c) v[c] = to_float(src[c * cstep]);
#pragma unroll
    for (int k = 0; k < RY; ++k) {
      const int i = r - k;
      if (i < 0 || i >= kTaps) continue;
#pragma unroll
      for (int m = 0; m < RX; ++m)
#pragma unroll
        for (int j = 0; j < kTaps; ++j)
          acc[k][m] = fmaf(v[m + j], g[i * kTaps + j], acc[k][m]);
    }
  }
}

// A 2-D filter: a warp's lanes are (x phase, group) pairs, lane = group *
// S + phase, each with kCols outputs of its phase; a warp's row job is a
// (y phase, group) pair with kRows2 outputs of its phase. Segment (plane b,
// offset o) of an axis reads the tile at (o + i) * step + b. The stores go
// through shuffles, so that a warp's store writes 32 consecutive columns.
template <typename T>
__device__ __forceinline__ void pass_2d(const AnyArgs& a, const float* taps,
                                        const int2* table, const T* raw,
                                        Shift sh, T* y, int ox0, int oy0,
                                        int warps) {
  const Axis &ax = a.ax, &ay = a.ay;
  const int lane = threadIdx.x & 31;
  const bool live = lane < ax.phases * ax.groups;
  const int phx = lane % ax.phases, gx = lane / ax.phases;
  const int nx = ax.phases * ax.segs;
  const int2* table_y = table + nx;
  // the owner and register of column 32 * m + lane of the tile
  int owner[kCols], reg[kCols];
  bool kept[kCols];
#pragma unroll
  for (int m = 0; m < kCols; ++m) {
    const int c = 32 * m + lane, t = c / ax.phases;
    owner[m] = ((t / kCols) * ax.phases + c - t * ax.phases) & 31;
    reg[m] = t % kCols;
    kept[m] = c < ax.tile && ox0 + c < a.OW;
  }
  for (int job = threadIdx.x >> 5; job < ay.phases * ay.groups;
       job += warps) {
    const int phy = job % ay.phases, gy = job / ay.phases;
    float acc[kRows2][kCols];
#pragma unroll
    for (int k = 0; k < kRows2; ++k)
#pragma unroll
      for (int m = 0; m < kCols; ++m) acc[k][m] = 0.f;
    if (live) {
      for (int jy = 0; jy < ay.segs; ++jy) {
        const int2 sy = table_y[phy * ay.segs + jy];
        for (int jx = 0; jx < ax.segs; ++jx) {
          const int2 sx = table[phx * ax.segs + jx];
          const float4* g4 = reinterpret_cast<const float4*>(
              taps + ((phy * ay.segs + jy) * nx + phx * ax.segs + jx) *
                         kTaps * kTaps);
          float g[kTaps * kTaps];
#pragma unroll
          for (int i = 0; i < kTaps * kTaps / 4; ++i) {
            const float4 q = g4[i];
            g[4 * i] = q.x;
            g[4 * i + 1] = q.y;
            g[4 * i + 2] = q.z;
            g[4 * i + 3] = q.w;
          }
          window<kRows2, kCols>(acc, raw, a.pitch, sh,
                                (sy.y + gy * kRows2) * ay.step + sy.x,
                                ay.step, (sx.y + gx * kCols) * ax.step + sx.x,
                                ax.step, g);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRows2; ++k) {
      const int oy = oy0 + (gy * kRows2 + k) * ay.phases + phy;
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        float v = 0.f;
#pragma unroll
        for (int r = 0; r < kCols; ++r) {
          const float w = __shfl_sync(0xffffffffu, acc[k][r], owner[m]);
          if (r == reg[m]) v = w;
        }
        if (kept[m] && oy < a.OH)
          y[(long long)oy * a.OW + ox0 + 32 * m + lane] = from_float<T>(v);
      }
    }
  }
}

// A separable filter's x pass: every fetched row's tile columns into the
// map `mid` (ay.step planes by row mod ay.step; a row is the tile's
// columns in order); lanes as in pass_2d, a warp a row. A phase's segments
// after its first add into what the first wrote.
template <typename T>
__device__ __forceinline__ void pass_x(const AnyArgs& a, const float* taps,
                                       const int2* table, const T* raw,
                                       Shift sh, float* mid, int warps) {
  const Axis &ax = a.ax, &ay = a.ay;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane >= ax.phases * ax.groups) return;
  const int phx = lane % ax.phases, gx = lane / ax.phases;
  const int wq = warps / ay.step, wr = warps - wq * ay.step;
  for (int j = 0; j < ax.segs; ++j) {
    const int2 s = table[phx * ax.segs + j];
    const float* g = taps + (phx * ax.segs + j) * kTaps;
    float h[kTaps];
#pragma unroll
    for (int c = 0; c < kTaps; ++c) h[c] = g[c];
    const int col = (s.y + gx * kCols) * ax.step + s.x;
    int rq = warp / ay.step, rr = warp - rq * ay.step;
    for (int r = warp; r < a.rows; r += warps) {
      const T* src = tile_row(raw, a.pitch, sh, r) + col;
      float v[kCols + kTaps - 1];
#pragma unroll
      for (int c = 0; c < kCols + kTaps - 1; ++c)
        v[c] = to_float(src[c * ax.step]);
      float* out = mid + rr * a.mid_floats + rq * ax.tile + gx * kCols *
                   ax.phases + phx;
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        float acc = j ? out[m * ax.phases] : 0.f;
#pragma unroll
        for (int c = 0; c < kTaps; ++c) acc = fmaf(v[m + c], h[c], acc);
        out[m * ax.phases] = acc;
      }
      rq += wq;
      rr += wr;
      if (rr >= ay.step) {
        rr -= ay.step;
        ++rq;
      }
    }
  }
}

// A separable filter's y pass: a warp a row job (y phase, group), a lane
// every 32nd tile column of it, kRows outputs of the phase down the map.
template <typename T>
__device__ __forceinline__ void pass_y(const AnyArgs& a, const float* taps,
                                       const int2* table, const float* mid,
                                       T* y, int ox0, int oy0, int warps) {
  const Axis &ax = a.ax, &ay = a.ay;
  const int nx = ax.phases * ax.segs;
  for (int job = threadIdx.x >> 5; job < ay.phases * ay.groups;
       job += warps)
  for (int col = threadIdx.x & 31; col < ax.tile; col += 32) {
    const int phy = job % ay.phases, gy = job / ay.phases;
    float acc[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc[k] = 0.f;
    for (int j = 0; j < ay.segs; ++j) {
      const int2 s = table[nx + phy * ay.segs + j];
      const float* g = taps + (nx + phy * ay.segs + j) * kTaps;
      const float* src =
          mid + s.x * a.mid_floats + (s.y + gy * kRows) * ax.tile + col;
      float v[kRows + kTaps - 1];
#pragma unroll
      for (int i = 0; i < kRows + kTaps - 1; ++i) v[i] = src[i * ax.tile];
#pragma unroll
      for (int c = 0; c < kTaps; ++c) {
        const float h = g[c];
#pragma unroll
        for (int k = 0; k < kRows; ++k) acc[k] = fmaf(v[k + c], h, acc[k]);
      }
    }
    const int ox = ox0 + col;
    if (ox < a.OW) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int oy = oy0 + (gy * kRows + k) * ay.phases + phy;
        if (oy < a.OH) y[(long long)oy * a.OW + ox] = from_float<T>(acc[k]);
      }
    }
  }
}

// The template's up, down and taps are 0, as instance 0's; SEP: a
// separable filter (x pass into shared memory, then y pass).
template <typename T, int U, int D, int K, int SEP>
__global__ void __launch_bounds__(kThreads, SEP ? kBlocksSep : kBlocks2)
upfirdn2d_nchw_kernel(AnyArgs a) {
  static_assert(U == 0 && D == 0 && K == 0, "instance 0's run-time kernel");
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float4 smem4[];
  float* taps = reinterpret_cast<float*>(smem4);
  int2* table = reinterpret_cast<int2*>(taps + a.taps_floats);
  float* mid = taps + a.taps_floats +
               ((2 * (a.ax.phases * a.ax.segs + a.ay.phases * a.ay.segs) +
                 3) & ~3);
  T* raw = reinterpret_cast<T*>(taps + a.raw_at);
  __shared__ alignas(8) unsigned long long fetched;
  const unsigned bar =
      static_cast<unsigned>(__cvta_generic_to_shared(&fetched));
  arrange<SEP>(a, taps, table);
  // zeros where no fetch writes: the rows outside the image, the words of
  // the columns outside it
  for (int i = threadIdx.x; i < a.rows * a.pitch * (int)sizeof(T) / 16;
       i += blockDim.x)
    reinterpret_cast<uint4*>(raw)[i] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    // one arrival a phase: warp 0's, with the bytes it expects
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int by = blockIdx.x / a.ax.tiles, bx = blockIdx.x - by * a.ax.tiles;
  const int ox0 = bx * a.ax.tile, oy0 = by * a.ay.tile;
  const int c0 = a.ax.first + bx * a.ax.span * a.ax.step;
  const int r0 = a.ay.first + by * a.ay.span * a.ay.step;
  const long long planes = (long long)a.N * a.C;
  int parity = 0;
  for (long long p = blockIdx.y; p < planes; p += gridDim.y) {
    const T* x = static_cast<const T*>(a.x) + p * a.H * a.W;
    T* y = static_cast<T*>(a.y) + p * a.OH * a.OW;
    if (threadIdx.x < 32) {
      // the generic proxy's accesses to `raw` are done (the barrier before)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fetch(raw, x, a, r0, c0, bar);
    }
    wait_fetched(bar, parity);
    parity ^= 1;
    edges(raw, x, a, r0, c0);
    const Shift sh = {misalign(x + (long long)r0 * a.W + c0),
                      a.W & (16 / (int)sizeof(T) - 1)};
    __syncthreads();
    if (SEP) {
      pass_x(a, taps, table, raw, sh, mid, kWarps);
      __syncthreads();
      pass_y(a, taps, table, mid, y, ox0, oy0, kWarps);
    } else {
      pass_2d<T>(a, taps, table, raw, sh, y, ox0, oy0, kWarps);
    }
    __syncthreads();  // the fetched tile and the map are free again
  }
}

template <typename T, int SEP>
cudaError_t launch(AnyArgs& a, cudaStream_t stream) {
  // lanes along x and row jobs along y; fewer rows, then fewer lanes, while
  // the tile needs more than the target
  const int px = a.ax.up / gcd(a.ax.up, a.ax.down);
  const int py = a.ay.up / gcd(a.ay.up, a.ay.down);
  // a warp's lanes hold the x phases: more than 32 is the wrapper's to
  // route elsewhere (ops/upfirdn2d.py ANY_NCHW_PHASES)
  if (px > 32) return cudaErrorInvalidValue;
  constexpr int rows = SEP ? kRows : kRows2;
  int gx = px < 32 ? 32 / px : 1;
  int gy = py < kThreads / 32 ? kThreads / 32 / py : 1;
  const size_t target = SEP ? kTargetSep : kTarget2;
  size_t bytes;
  for (;;) {
    axis_geometry(a.ax, a.ax.up, a.ax.down, a.ax.pad, a.fw, a.OW, kCols, gx);
    axis_geometry(a.ay, a.ay.up, a.ay.down, a.ay.pad, a.fh, a.OH, rows, gy);
    bytes = layout(a, SEP, sizeof(T));
    if (bytes <= target || (gx == 1 && gy == 1)) break;
    if (gy > 1)
      gy /= 2;
    else
      gx /= 2;
  }
  if (bytes > kMost) return cudaErrorInvalidValue;
  auto kernel = upfirdn2d_nchw_kernel<T, 0, 0, 0, SEP>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const long long tiles = (long long)a.ax.tiles * a.ay.tiles;
  const long long planes = (long long)a.N * a.C;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  // planes a block (its taps and zeros set once): a 2-D filter's up to 4
  // while the grid keeps 2048 blocks, a separable one's 1
  long long per = SEP ? 1 : tiles * planes / 2048;
  per = per < 1 ? 1 : per > 4 ? 4 : per;
  long long groups = (planes + per - 1) / per;
  if (groups > 65535) groups = 65535;
  const dim3 grid((unsigned)tiles, (unsigned)groups);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// instance 0 on NCHW tensors; sep: f is a 1-D filter of fw (= fh) taps,
// applied along x then y in one launch
template <typename T>
cudaError_t call(const Args& b, int sep, cudaStream_t stream) {
  AnyArgs a;
  a.x = b.x;
  a.y = b.y;
  a.f = b.f;
  a.N = b.N; a.C = b.C; a.H = b.H; a.W = b.W; a.OH = b.OH; a.OW = b.OW;
  a.fw = b.fw; a.fh = b.fh; a.fsx = b.fsx; a.fsy = b.fsy; a.flip = b.flip;
  a.gain = b.gain;
  a.ax.up = b.upx; a.ax.down = b.downx; a.ax.pad = b.padx0;
  a.ay.up = b.upy; a.ay.down = b.downy; a.ay.pad = b.pady0;
  return sep ? launch<T, 1>(a, stream) : launch<T, 0>(a, stream);
}

}  // namespace any_nchw

template <typename T, int VEC>
cudaError_t dispatch(const Args& a, int channels_last, int which, int sep,
                     cudaStream_t stream) {
  const bool k4 = a.fw == 4 && a.fh == 4;
  if (sep && (which != 0 || channels_last)) return cudaErrorInvalidValue;
  switch (which) {
    case 0:
      if (!channels_last) return any_nchw::call<T>(a, sep, stream);
      return nhwc<T, VEC, 0, 0, 0, 8, 1>(a, stream);
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
// at (up, down) (1, 1), (2, 1), (1, 2) on both axes. sep: instance 0 in
// NCHW order with a 1-D filter of fw = fh taps, x tap j at f[j * fsx] and y
// tap i at f[i * fsy], along both axes in one launch.
extern "C" int upfirdn2d(const void* x, void* y, const void* f, int bf16,
                         int channels_last, int vec, int which, int sep,
                         int N, int C, int H, int W, int OH, int OW, int upx,
                         int upy, int downx, int downy, int padx0, int pady0,
                         int fw, int fh, int fsx, int fsy, int flip,
                         float gain, void* stream) {
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
    return vec ? (int)dispatch<__nv_bfloat16, 8>(a, channels_last, which,
                                                 sep, s)
               : (int)dispatch<__nv_bfloat16, 1>(a, channels_last, which,
                                                 sep, s);
  }
  return vec ? (int)dispatch<float, 4>(a, channels_last, which, sep, s)
             : (int)dispatch<float, 1>(a, channels_last, which, sep, s);
}

extern "C" const char* upfirdn2d_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
