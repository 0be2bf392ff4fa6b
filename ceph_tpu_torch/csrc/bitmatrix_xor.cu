// Packet XOR over a GF(2) bit-matrix on Hopper:
// out[i, :] = XOR over {j : B[i, j] = 1} of in[j, :], in [K, n4], out [M, n4].
//
// Replaces make_bitmatrix_matmul_pallas (ceph_tpu/ops/gf_pallas.py), the
// engine behind jerasure's cauchy_orig / cauchy_good / liberation /
// blaum_roth / liber8tion encode and their decode through a recovery
// bit-matrix.
//
// Design:
// - The bit-matrix is a runtime argument.  The host packs it once per
//   matrix, per output tile of MT rows, as masks[tile][j]: bit i set
//   when output tile*MT+i takes input row j.  Each block stages its
//   tile's K masks in shared memory.
// - Each thread owns V consecutive lanes of every row.  It reads each
//   input row once (a row no output of the tile uses is never read) and
//   XORs it into the MT register accumulators its mask selects; the
//   mask tests are uniform across the block.
// - MT and V trade accumulators against load width: (8, 4), (16, 4),
//   (32, 2), (64, 1), so at most 64 accumulator registers a thread.
//   Outputs above 64 are split over blockIdx.y, and the input is then
//   read once per output tile.
//
// Bound on an H100: one XOR per set bit per lane, a few per input byte,
// so device memory bounds it; see PERF.md for its time.

#include "lanes.cuh"

namespace {

constexpr int THREADS = 256;

template <int MT, int V>
__global__ void __launch_bounds__(THREADS)
bitmatrix_xor_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                     const unsigned long long* __restrict__ masks, int K, int M,
                     long long n4, int vec) {
  extern __shared__ unsigned long long s_mask[];  // [K], this block's output tile
  const unsigned long long* t = masks + (long long)blockIdx.y * K;
  for (int idx = threadIdx.x; idx < K; idx += THREADS) s_mask[idx] = t[idx];
  __syncthreads();

  const long long c0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * V;
  if (c0 >= n4) return;

  uint32_t acc[MT][V];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[i][v] = 0u;

  for (int j = 0; j < K; ++j) {
    const unsigned long long mask = s_mask[j];
    if (mask == 0ull) continue;
    uint32_t x[V];
    load_lanes<V>(in + (long long)j * n4, c0, n4, vec != 0, x);
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if ((mask >> i) & 1ull)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[i][v] ^= x[v];
  }

  const int rows = min(MT, M - (int)blockIdx.y * MT);
#pragma unroll
  for (int i = 0; i < MT; ++i)
    if (i < rows)
      store_lanes<V>(out + (long long)(blockIdx.y * MT + i) * n4, c0, n4, vec != 0, acc[i]);
}

template <int MT, int V>
int launch(const void* in, void* out, const void* masks, int K, int M,
           long long n4, cudaStream_t stream) {
  const int vec = aligned_rows<V>(in, out, n4);
  const long long per_block = (long long)THREADS * V;
  const dim3 grid((unsigned)((n4 + per_block - 1) / per_block),
                  (unsigned)((M + MT - 1) / MT));
  const size_t smem = (size_t)K * sizeof(unsigned long long);
  bitmatrix_xor_kernel<MT, V><<<grid, THREADS, smem, stream>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<const unsigned long long*>(masks), K, M, n4, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the launch's cudaGetLastError() (0 on success), or -1 for an
// mt that was not built.
extern "C" int bitmatrix_xor_launch(const void* in, void* out, const void* masks,
                                    int K, int M, int mt, long long n4,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mt) {
    case 8: return launch<8, 4>(in, out, masks, K, M, n4, s);
    case 16: return launch<16, 4>(in, out, masks, K, M, n4, s);
    case 32: return launch<32, 2>(in, out, masks, K, M, n4, s);
    case 64: return launch<64, 1>(in, out, masks, K, M, n4, s);
    default: return -1;
  }
}
