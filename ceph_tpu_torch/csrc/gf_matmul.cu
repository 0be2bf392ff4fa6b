// GF(2^w) region matrix multiply on Hopper: parity[m, n4] = M[m, k] . data[k, n4].
//
// Replaces make_gf_matmul_pallas (ceph_tpu/ops/gf_pallas.py).  Same
// arithmetic, the doubling method: in GF(2^w), 2*x is a masked shift
// plus a conditional XOR of the field polynomial, and c*x is the XOR of
// 2^b*x over the set bits b of c.  Each uint32 lane packs 4 (w=8) or 2
// (w=16) symbols, byte-order identical to the uint8 chunk layout.
//
// Design:
// - The matrix is a runtime argument.  The host packs it once per
//   matrix, per output tile of MT rows, as table[tile][j][i] (zero past
//   m); each block stages its tile's [k][MT] coefficients in shared
//   memory.  One build serves every coding and recovery matrix.
// - Each thread owns V=4 consecutive lanes of every row (one 16-byte
//   load).  It reads each input row once, walks that row's doubling
//   chain only up to the highest bit any coefficient of the tile needs,
//   and XORs the powers into MT register accumulators where the
//   coefficient's bit is set.  The coefficient tests are uniform across
//   the block, so they never diverge.
// - Outputs above MT=16 are split over blockIdx.y; the input is then
//   read once per output tile.
//
// Bound on an H100: a doubling is at least 5 integer operations (the
// final mask and XOR fold into one LOP3), and LOP3 folds the XOR terms
// of one output pairwise.  Jerasure's RS(8,3) matrix needs 56 doublings
// and 83 terms per column of k=8 lanes, 321 operations per 32 input
// bytes, so it is bound by the integer ALUs; the ISA RS(8,3) matrix
// needs 36 doublings and 36 terms, 198 operations, and is bound by
// device memory.  chip_smoke.py computes both bounds for the matrix it
// times.  Speed is not this kernel's goal yet; see PERF.md for its time.

#include "lanes.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int V = 4;

template <int W>
__device__ __forceinline__ uint32_t gf_double(uint32_t x);

template <>
__device__ __forceinline__ uint32_t gf_double<8>(uint32_t x) {
  const uint32_t high = (x >> 7) & 0x01010101u;
  return ((x & 0x7f7f7f7fu) << 1) ^ (high * 0x1du);
}

template <>
__device__ __forceinline__ uint32_t gf_double<16>(uint32_t x) {
  const uint32_t high = (x >> 15) & 0x00010001u;
  return ((x & 0x7fff7fffu) << 1) ^ (high * 0x100bu);
}

template <int W, int MT>
__global__ void __launch_bounds__(THREADS)
gf_matmul_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 const int32_t* __restrict__ table, int k, int m, long long n4,
                 int vec) {
  extern __shared__ uint32_t s_coef[];  // [k][MT], this block's output tile
  const int tile = blockIdx.y;
  const int32_t* t = table + (long long)tile * k * MT;
  for (int idx = threadIdx.x; idx < k * MT; idx += THREADS)
    s_coef[idx] = static_cast<uint32_t>(t[idx]);
  __syncthreads();

  const long long c0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * V;
  if (c0 >= n4) return;

  uint32_t acc[MT][V];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[i][v] = 0u;

  for (int j = 0; j < k; ++j) {
    uint32_t c[MT];
    uint32_t any = 0u;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      c[i] = s_coef[j * MT + i];
      any |= c[i];
    }
    if (any == 0u) continue;  // no output of this tile uses row j
    uint32_t x[V];
    load_lanes<V>(in + (long long)j * n4, c0, n4, vec != 0, x);
#pragma unroll
    for (int b = 0; b < W; ++b) {
      if (b > 0) {
        if ((any >> b) == 0u) break;  // chain ends at the highest needed bit
#pragma unroll
        for (int v = 0; v < V; ++v) x[v] = gf_double<W>(x[v]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if ((c[i] >> b) & 1u)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[i][v] ^= x[v];
    }
  }

  const int rows = min(MT, m - tile * MT);
#pragma unroll
  for (int i = 0; i < MT; ++i)
    if (i < rows)
      store_lanes<V>(out + (long long)(tile * MT + i) * n4, c0, n4, vec != 0, acc[i]);
}

template <int W, int MT>
int launch(const void* in, void* out, const void* table, int k, int m,
           long long n4, cudaStream_t stream) {
  const int vec = aligned_rows<V>(in, out, n4);
  const long long per_block = (long long)THREADS * V;
  const dim3 grid((unsigned)((n4 + per_block - 1) / per_block),
                  (unsigned)((m + MT - 1) / MT));
  const size_t smem = (size_t)k * MT * sizeof(uint32_t);
  gf_matmul_kernel<W, MT><<<grid, THREADS, smem, stream>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<const int32_t*>(table), k, m, n4, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the launch's cudaGetLastError() (0 on success), or -1 for a
// (w, mt) pair that was not built.
extern "C" int gf_matmul_launch(const void* in, void* out, const void* table,
                                int w, int k, int m, int mt, long long n4,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GF_CASE(W, MT)                                            \
  if (w == W && mt == MT)                                         \
    return launch<W, MT>(in, out, table, k, m, n4, s);
  GF_CASE(8, 1) GF_CASE(8, 2) GF_CASE(8, 4) GF_CASE(8, 8) GF_CASE(8, 16)
  GF_CASE(16, 1) GF_CASE(16, 2) GF_CASE(16, 4) GF_CASE(16, 8) GF_CASE(16, 16)
#undef GF_CASE
  return -1;
}
