// GF(2^w) region matrix multiply on Hopper: parity[m, n4] = M[m, k] . data[k, n4].
//
// Replaces make_gf_matmul_pallas (ceph_tpu/ops/gf_pallas.py).  Same
// arithmetic, the doubling method: in GF(2^w), 2*x is a masked shift
// plus a conditional XOR of the field polynomial, and c*x is the XOR of
// 2^b*x over the set bits b of c.  Each uint32 lane packs 4 (w=8) or 2
// (w=16) symbols, byte-order identical to the uint8 chunk layout.
//
// What bounds it.  Every input byte is read once and every output byte
// written once, so device memory bounds it unless the matrix needs more
// integer operations than the card issues in that time: a doubling is 4
// (PRMT for the per-symbol high bits, AND, shift, one LOP3 that folds
// the masked reduction term), and LOP3 folds the XOR terms of an output
// pairwise.  ISA's RS(8,3) matrix is bound by bytes, jerasure's (every
// chain 7 long) by operations.  chip_smoke.py computes both bounds.
// An earlier design, one 16-byte load per thread in flight behind each
// row's doubling chain and a predicated XOR per (row, bit, output), ran
// at half its bound; this one overlaps the chains with the traffic and
// issues about half the instructions (PERF.md, Findings).
//
// Design (the Pallas kernel unrolls the matrix at trace time; here it is
// a runtime plan, so one build serves encode and every recovery matrix):
// - The plan.  The host compiles the matrix once (gf_cuda.gf_table) into
//   one Plan per launch (an output tile and a chunk of input rows): for
//   each input row the chain length nb (the highest coefficient bit the
//   tile needs, 0 when the tile does not use the row), and for each
//   (row, bit) the mask of the tile's outputs whose coefficient has that
//   bit.  It is passed by value as a
//   __grid_constant__, so it lives in the constant bank and every test
//   on it is the same for all threads: a thread XORs a power into an
//   accumulator only where the mask says so, and walks a row's chain
//   only as far as nb.
// - Output tiles of 1, 2, 3, 4, 6, 8 or 16 rows, so m=3 keeps 3
//   accumulators; a matrix's outputs split into tiles of 16 and one
//   tile of the rest rounded up, one launch each, each reading the input
//   once.  Each launch takes its own 4.4 KB plan.
// - Input rows past the plan's capacity (256 at w=8, 128 at w=16) split
//   into row chunks, one launch each; every launch after a tile's first
//   XORs its sums into the outputs (`accumulate`).
// - An asynchronous ring.  Persistent blocks walk column tiles of T
//   lanes.  A producer warp keeps S-1 stages of a shared-memory ring
//   ahead of the consumers, each stage KC input rows x T lanes, filled by
//   one 1-D bulk copy (TMA) per row that completes on the stage's full
//   mbarrier; consumers release a stage on its empty mbarrier.  The
//   consumers spend no instructions on loads beyond 16-byte shared
//   reads, so the doubling chains overlap the memory traffic, and the
//   stage size does not depend on k.  Rows that the bulk copy cannot
//   take (not 16-byte aligned) are filled by the producer warp with
//   plain loads into the same stage.  The bulk loads ask L2 to evict the
//   input first, which leaves L2 to the outputs being written.
// - Consumers own V lanes of every row, in groups of 4 so that a warp's
//   16-byte shared reads and global stores are contiguous, and keep
//   MT x V accumulators in registers across the row chunks of a tile.
//
// The tuning constants come from the sweep of
// ceph_tpu_torch/tools/gf_matmul_sweep.py (PERF.md, Findings).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int CONSUMERS = 256;           // consumer threads a block
constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
constexpr int V_MAX = 8;                 // lanes a consumer thread owns
constexpr int KC = 1;                    // input rows a ring stage holds
constexpr int S = 4;                     // ring stages
constexpr int MAX_DEVICES = 64;          // launch() caches its grid per device
// Plan capacity of one launch: 256 input rows at w=8, 128 at w=16.  Kept
// in step with PLAN_ROWS and PLAN_MASKS in ceph_tpu_torch/ops/gf_cuda.py.
constexpr int PLAN_ROWS = 256;
constexpr int PLAN_MASKS = 8 * PLAN_ROWS;
static_assert(CONSUMERS % 32 == 0 && V_MAX % 4 == 0, "bad tile constants");

struct Plan {
  uint8_t nb[PLAN_ROWS];       // [row]: chain length, 0 = skip
  uint16_t mask[PLAN_MASKS];   // [row][bit]: outputs taking 2^bit * x
};

// Lanes per thread: wide tiles keep fewer so the accumulators fit.
template <int MT>
__host__ __device__ constexpr int lanes_per_thread() { return MT > 8 ? 4 : V_MAX; }

// 2*x for every symbol of a packed lane: PRMT in its sign mode copies
// each symbol's high bit over the whole symbol, which selects the
// reduction polynomial; the high bits are masked off before the shift.
template <int W>
__device__ __forceinline__ uint32_t gf_double(uint32_t x);

template <>
__device__ __forceinline__ uint32_t gf_double<8>(uint32_t x) {
  uint32_t high;  // 0xff in each byte whose bit 7 is set
  asm("prmt.b32 %0, %1, %2, 0xBA98;" : "=r"(high) : "r"(x), "r"(0u));
  return ((x & 0x7f7f7f7fu) << 1) ^ (high & 0x1d1d1d1du);
}

template <>
__device__ __forceinline__ uint32_t gf_double<16>(uint32_t x) {
  uint32_t high;  // 0xffff in each half whose bit 15 is set
  asm("prmt.b32 %0, %1, %2, 0xBB99;" : "=r"(high) : "r"(x), "r"(0u));
  return ((x & 0x7fff7fffu) << 1) ^ (high & 0x100b100bu);
}

// Producer: the one warp that fills the ring, stage after stage, in the
// consumers' order of (column tile, row chunk).  `bulk` says every row
// and the tile width are 16-byte aligned for the bulk copy.
template <int T>
__device__ void produce(const Plan& plan, const uint32_t* __restrict__ in,
                        uint32_t* ring, uint64_t* full, uint64_t* empty,
                        int k, long long n4, int nchunk, bool bulk) {
  const int lane = threadIdx.x & 31;
  int s = 0;             // ring stage
  uint32_t phase = 0;    // parity of the stage's current use
  long long it = 0;      // stages filled so far
  for (long long c0 = (long long)blockIdx.x * T; c0 < n4; c0 += (long long)gridDim.x * T) {
    const int lanes = n4 - c0 < T ? static_cast<int>(n4 - c0) : T;
    for (int j0 = 0; j0 < nchunk * KC; j0 += KC, ++it) {
      if (it >= S) mbar_wait(&empty[s], phase ^ 1u);
      const int rows = min(KC, k - j0);
      uint32_t* stage = ring + (size_t)s * KC * T;
      if (bulk) {
        if (lane == 0) {
          uint32_t bytes = 0;
          for (int r = 0; r < rows; ++r)
            if (plan.nb[j0 + r]) bytes += lanes * 4u;
          mbar_arrive_expect_tx(&full[s], bytes);
          for (int r = 0; r < rows; ++r)
            if (plan.nb[j0 + r])
              bulk_copy(stage + r * T, in + (long long)(j0 + r) * n4 + c0,
                        lanes * 4u, &full[s]);
        } else {
          mbar_arrive(&full[s]);
        }
      } else {
        for (int r = 0; r < rows; ++r) {
          if (!plan.nb[j0 + r]) continue;
          const uint32_t* src = in + (long long)(j0 + r) * n4 + c0;
          uint32_t* dst = stage + r * T;
          for (int c = lane; c < lanes; c += 32 * 8) {
            uint32_t v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              v[u] = c + 32 * u < lanes ? __ldg(src + c + 32 * u) : 0u;
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (c + 32 * u < lanes) dst[c + 32 * u] = v[u];
          }
        }
        mbar_arrive(&full[s]);  // each lane releases its own stores
      }
      if (++s == S) {
        s = 0;
        phase ^= 1u;
      }
    }
  }
}

template <int W, int MT>
__global__ void __launch_bounds__(THREADS)
gf_matmul_kernel(const __grid_constant__ Plan plan, const uint32_t* __restrict__ in,
                 uint32_t* __restrict__ out, int k, int m, long long n4, int bulk,
                 int vec_out, int accumulate) {
  constexpr int V = lanes_per_thread<MT>();
  constexpr int G = V / 4;              // 16-byte groups a thread owns
  constexpr int T = CONSUMERS * V;      // lanes a column tile
  extern __shared__ __align__(128) uint32_t ring[];  // [S][KC][T]
  __shared__ __align__(8) uint64_t full[S], empty[S];

  const int nchunk = max(1, (k + KC - 1) / KC);  // k = 0 still stores zeros

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    produce<T>(plan, in, ring, full, empty, k, n4, nchunk, bulk != 0);
    return;
  }

  const int t = threadIdx.x;
  uint32_t acc[MT][V];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[i][v] = 0u;

  int s = 0;
  uint32_t phase = 0;
  for (long long c0 = (long long)blockIdx.x * T; c0 < n4; c0 += (long long)gridDim.x * T) {
    for (int j0 = 0; j0 < nchunk * KC; j0 += KC) {
      mbar_wait(&full[s], phase);
      const int rows = min(KC, k - j0);
      const uint32_t* stage = ring + (size_t)s * KC * T + t * 4;
#pragma unroll 1
      for (int r = 0; r < rows; ++r) {
        const int row = j0 + r;
        const int nb = plan.nb[row];
        if (nb == 0) continue;
        uint32_t x[V];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const uint4 q =
              *reinterpret_cast<const uint4*>(stage + r * T + g * CONSUMERS * 4);
          x[4 * g] = q.x; x[4 * g + 1] = q.y; x[4 * g + 2] = q.z; x[4 * g + 3] = q.w;
        }
        const uint16_t* mk = plan.mask + row * W;
#pragma unroll
        for (int b = 0; b < W; ++b) {
          if (b > 0) {
            if (b >= nb) break;
#pragma unroll
            for (int v = 0; v < V; ++v) x[v] = gf_double<W>(x[v]);
          }
          const uint32_t mask = mk[b];
#pragma unroll
          for (int i = 0; i < MT; ++i)
            if (mask & (1u << i))
#pragma unroll
              for (int v = 0; v < V; ++v) acc[i][v] ^= x[v];
        }
      }
      mbar_arrive(&empty[s]);
      if (++s == S) {
        s = 0;
        phase ^= 1u;
      }
    }

#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < m) {
        uint32_t* orow = out + (long long)i * n4;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const long long c = c0 + g * CONSUMERS * 4 + t * 4;
          if (vec_out && c + 4 <= n4) {
            uint4* o = reinterpret_cast<uint4*>(orow + c);
            uint4 q = make_uint4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                                 acc[i][4 * g + 3]);
            if (accumulate) {
              const uint4 p = *o;
              q.x ^= p.x; q.y ^= p.y; q.z ^= p.z; q.w ^= p.w;
            }
            *o = q;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (c + q < n4)
                orow[c + q] = accumulate ? orow[c + q] ^ acc[i][4 * g + q]
                                         : acc[i][4 * g + q];
          }
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) acc[i][v] = 0u;
    }
  }
}

template <int W, int MT>
int launch(const Plan& plan, const void* in, void* out, int k, int m, long long n4,
           int accumulate, cudaStream_t stream) {
  constexpr int T = CONSUMERS * lanes_per_thread<MT>();
  constexpr size_t smem = (size_t)S * KC * T * sizeof(uint32_t);
  // per device: SMs x the blocks an SM holds, 0 until the first launch there
  static std::atomic<int> grid_cap[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int cap = dev < MAX_DEVICES ? grid_cap[dev].load(std::memory_order_acquire) : 0;
  if (cap == 0) {
    auto kernel = gf_matmul_kernel<W, MT>;
    // the ring plus the static barriers may pass the default 48 KB
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    int sms = 0, fit = 0;
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, THREADS, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    cap = sms * (fit > 0 ? fit : 1);
    if (dev < MAX_DEVICES) grid_cap[dev].store(cap, std::memory_order_release);
  }
  const long long ncol = (n4 + T - 1) / T;
  const unsigned grid = (unsigned)(ncol < cap ? ncol : cap);
  const int bulk = reinterpret_cast<uintptr_t>(in) % 16 == 0 && n4 % 4 == 0;
  const int vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0 && n4 % 4 == 0;
  gf_matmul_kernel<W, MT><<<grid, THREADS, smem, stream>>>(
      plan, static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), k, m, n4,
      bulk, vec_out, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gf_matmul_plan_bytes() { return static_cast<int>(sizeof(Plan)); }

// One launch: output tile `out` (its first row; `m` rows, at most mt)
// from input rows `in` (its first row; `k` rows), with `plan` one of the
// host buffers gf_cuda.gf_table packs (sizeof(Plan) bytes).  With
// `accumulate` the sums are XORed into `out`, else stored.  Returns the
// launch's cudaGetLastError() (0 on success), or -1 for a (w, mt) pair
// that was not built.
extern "C" int gf_matmul_launch(const void* in, void* out, const void* plan, int w,
                                int k, int m, int mt, long long n4, int accumulate,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  std::memcpy(&p, plan, sizeof(Plan));
#define GF_CASE(W, MT) \
  if (w == W && mt == MT) return launch<W, MT>(p, in, out, k, m, n4, accumulate, s);
#define GF_CASES(W) \
  GF_CASE(W, 1) GF_CASE(W, 2) GF_CASE(W, 3) GF_CASE(W, 4) GF_CASE(W, 6) GF_CASE(W, 8) \
  GF_CASE(W, 16)
  GF_CASES(8)
  GF_CASES(16)
#undef GF_CASES
#undef GF_CASE
  return -1;
}
