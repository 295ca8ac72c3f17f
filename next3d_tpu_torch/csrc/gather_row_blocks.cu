// Aligned 8-row block gather for Hopper (sm_90a): K6.
//
// Replaces the TPU kernel next3d_tpu/ops/pallas_dma_gather.py
// dma_gather_row_blocks (kernel _gather_kernel), which issued one DMA per
// index through a ring of semaphores because a TPU core could slice its HBM
// table only at 8-row boundaries. The function is unchanged:
// out[i] = table[8 * (idx[i] / 8) : 8 * (idx[i] / 8) + 8], an (M, 8, C)
// result, row idx[i] sitting at out[i, idx[i] % 8]. An index outside
// [0, R) gives a block of zero bytes.
//
// What bounds it on the H100: bytes. Each index moves one 8 x C block
// (2 KB for 128 bf16 channels, 4 KB for f32) from the table to the output
// and computes nothing; the output, M blocks, is written once and is most
// of the traffic. The design gives each index one warp, which copies the
// block with 16-byte vector loads and stores, 32 lanes on 32 neighbouring
// 16-byte words, so every access is a full coalesced line. It works on
// bytes, so one kernel serves f32 and bf16 (the wrapper checks that a
// block is a whole number of 16-byte words and that the pointers are
// 16-byte aligned).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
gather_row_blocks_kernel(const uint4* __restrict__ table,  // (R / 8) blocks
                         const int32_t* __restrict__ idx,   // (M,)
                         uint4* __restrict__ out,           // (M) blocks
                         int64_t n_idx, int rows, int words_per_block) {
  const int64_t i = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (i >= n_idx) return;
  const int lane = threadIdx.x % 32;
  const int r = idx[i];
  uint4* dst = out + i * words_per_block;
  if (r < 0 || r >= rows) {
    for (int k = lane; k < words_per_block; k += 32)
      dst[k] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const uint4* src = table + (int64_t)(r / 8) * words_per_block;
  for (int k = lane; k < words_per_block; k += 32) dst[k] = __ldg(src + k);
}

}  // namespace

extern "C" int gather_row_blocks(const void* table, const void* idx,
                                 void* out, long long n_idx, int rows,
                                 int block_bytes, void* stream) {
  if (n_idx == 0) return 0;
  const unsigned grid = (unsigned)((n_idx + kWarps - 1) / kWarps);
  gather_row_blocks_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)table, (const int32_t*)idx, (uint4*)out, n_idx, rows,
      block_bytes / 16);
  return (int)cudaGetLastError();
}

extern "C" const char* gather_row_blocks_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
