// Packet XOR over a GF(2) bit-matrix on Hopper:
// out[i, :] = XOR over {j : B[i, j] = 1} of in[j, :], in [K, n4], out [M, n4].
//
// Replaces make_bitmatrix_matmul_pallas (ceph_tpu/ops/gf_pallas.py), the
// engine behind jerasure's cauchy_orig / cauchy_good / liberation /
// blaum_roth / liber8tion encode and their decode through a recovery
// bit-matrix.
//
// What bounds it.  One XOR per set bit per lane, a few per input byte,
// so device memory bounds it: each input row is read once and each
// output written once.  An earlier design (one thread per 2 lanes of all
// 32 outputs, each row's load issued only after the previous row's XOR
// block, every output's XOR issued whatever its bit, a grid of 1.3
// waves) ran at a quarter of that bound (PERF.md, Findings).
//
// Design (the Pallas kernel unrolls the matrix at trace time; here it is
// a runtime plan, so one build serves the encode matrix and every
// recovery matrix):
// - The plan.  The host (gf_cuda.bitmatrix_table) packs the matrix once
//   into one Plan per launch: an output tile of up to 32 rows and a
//   chunk of the input rows that tile uses.  A row no output of the
//   tile takes (the zero columns of a decode's widened recovery matrix)
//   is left out, so it costs no bytes.  The plan holds each used row's
//   index and, for each block of 32 used rows and each output, a word
//   of the rows that output takes.  It is passed by value as a
//   __grid_constant__, so every read of it is a uniform load from the
//   constant bank.
// - Output tiles of 8, 16 or 32 rows; a matrix's outputs split into
//   tiles of 32 and one tile of the rest rounded up, one launch each,
//   each reading its rows once.  Used rows past the plan's capacity
//   split into launches that XOR their sums into the outputs
//   (`accumulate`).
// - An asynchronous ring, as in gf_matmul.cu.  Persistent blocks walk
//   column tiles of T lanes.  A producer warp keeps S-1 stages of a
//   shared-memory ring ahead of the consumers, each stage KC used input
//   rows x T lanes, filled by one 1-D bulk copy (TMA) per row that
//   completes on the stage's full mbarrier; consumers release a stage on
//   its empty mbarrier.  Rows the bulk copy cannot take (not 16-byte
//   aligned) are filled by the producer warp with plain loads into the
//   same stage.
// - Output groups across warps.  The consumer warps split a tile's
//   outputs into GROUPS groups (4 outputs each for a tile of 32) that
//   all read the same staged rows.  A thread keeps its group's outputs
//   x V lanes in registers.  For each output it walks only the set bits
//   of that output's word for the stage (find-first-set), reading each
//   taken row's V lanes with 16-byte shared loads: a loop, not a
//   predicated XOR, so an unset bit costs nothing.  The group is a
//   template argument, so the words it reads are uniform.
// - Bulk stores.  At the end of a column tile each group writes its
//   sums to its rows of a shared-memory staging area and one of its
//   threads hands them to bulk copies into device memory (XOR
//   reductions when it accumulates), so the group goes on to the next
//   tile while they drain.  Outputs the bulk copy cannot take are
//   stored by the consumers themselves.
// - The grid is SMs x the blocks an SM holds, cached per device, cut to
//   divide the column tiles evenly among the blocks.
//
// The tuning constants come from the sweep of
// ceph_tpu_torch/tools/gf_matmul_sweep.py --kernel bitmatrix_xor
// (PERF.md, Findings).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int CONSUMERS = 512;           // consumer threads a block
constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
constexpr int GROUPS = 8;                // output groups of a tile
constexpr int V_MAX = 8;                 // lanes a consumer thread owns at most
constexpr int KC = 4;                    // input rows a ring stage holds
constexpr int S = 4;                     // ring stages
constexpr int ACC_MAX = 64;              // accumulators a thread at most
constexpr int MAX_DEVICES = 64;          // launch() caches its grid per device
constexpr int GT = CONSUMERS / GROUPS;   // consumer threads of a group
// Plan capacity of one launch: used input rows.  Kept in step with
// BM_PLAN_ROWS in ceph_tpu_torch/ops/gf_cuda.py.
constexpr int PLAN_ROWS = 512;
static_assert(GT % 32 == 0 && V_MAX % 4 == 0, "bad tile constants");
static_assert(32 / GROUPS * 4 <= ACC_MAX && 8 % GROUPS == 0, "bad output groups");
static_assert(32 % KC == 0 && PLAN_ROWS % 32 == 0, "a stage's rows lie in one word");

struct Plan {
  uint32_t row[PLAN_ROWS];            // [r]: input row of the r-th used row
  uint32_t bits[PLAN_ROWS / 32][32];  // [b][i]: bit r set when output i takes used row 32b+r
};

// Lanes per consumer thread: the widest that keeps the group's
// accumulators within ACC_MAX.
template <int MT>
__host__ __device__ constexpr int lanes_per_thread() {
  return (MT / GROUPS) * V_MAX <= ACC_MAX ? V_MAX : ACC_MAX / (MT / GROUPS);
}

// Producer: the one warp that fills the ring, stage after stage, in the
// consumers' order of (column tile, used-row chunk).  `bulk` says every
// row and the tile width are 16-byte aligned for the bulk copy.
template <int T>
__device__ void produce(const Plan& plan, const uint32_t* __restrict__ in,
                        uint32_t* ring, uint64_t* full, uint64_t* empty, int nrows,
                        long long n4, bool bulk) {
  const int lane = threadIdx.x & 31;
  int s = 0;             // ring stage
  uint32_t phase = 0;    // parity of the stage's current use
  long long it = 0;      // stages filled so far
  for (long long c0 = (long long)blockIdx.x * T; c0 < n4; c0 += (long long)gridDim.x * T) {
    const int lanes = n4 - c0 < T ? static_cast<int>(n4 - c0) : T;
    for (int r0 = 0; r0 < nrows; r0 += KC, ++it) {
      if (it >= S) mbar_wait(&empty[s], phase ^ 1u);
      const int rows = min(KC, nrows - r0);
      uint32_t* stage = ring + (size_t)s * KC * T;
      if (bulk) {
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], rows * lanes * 4u);
          for (int r = 0; r < rows; ++r)
            bulk_copy(stage + r * T, in + (long long)plan.row[r0 + r] * n4 + c0,
                      lanes * 4u, &full[s]);
        } else {
          mbar_arrive(&full[s]);
        }
      } else {
        for (int r = 0; r < rows; ++r) {
          const uint32_t* src = in + (long long)plan.row[r0 + r] * n4 + c0;
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

// Barrier of the GT consumer threads of output group GRP (barrier 0 is
// __syncthreads').
template <int GRP>
__device__ __forceinline__ void group_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(1 + GRP), "n"(GT) : "memory");
}

// Consumers of output group GRP: outputs [GRP*OG, GRP*OG + OG) of the
// tile, V lanes of every row a thread, in 16-byte groups spaced GT*4
// lanes apart so that a warp's shared reads and global stores are
// contiguous.
template <int MT, int GRP>
__device__ void consume(const Plan& plan, const uint32_t* ring, uint32_t* staging,
                        uint64_t* full, uint64_t* empty, uint32_t* __restrict__ out,
                        int nrows, int m, long long n4, bool bulk_out, bool accumulate) {
  constexpr int OG = MT / GROUPS;            // outputs of the group
  constexpr int V = lanes_per_thread<MT>();
  constexpr int C = V / 4;                   // 16-byte groups a thread owns
  constexpr int T = GT * V;                  // lanes a column tile
  constexpr uint32_t STAGE_BITS = KC == 32 ? ~0u : (1u << KC) - 1u;
  const int t = threadIdx.x % GT;
  uint32_t* mine = staging + GRP * OG * T;   // the group's [OG][T] outputs

  uint32_t acc[OG][V];
  int s = 0;
  uint32_t phase = 0;
  for (long long c0 = (long long)blockIdx.x * T; c0 < n4; c0 += (long long)gridDim.x * T) {
#pragma unroll
    for (int i = 0; i < OG; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[i][v] = 0u;

    for (int r0 = 0; r0 < nrows; r0 += KC) {
      mbar_wait(&full[s], phase);
      const uint32_t* stage = ring + (size_t)s * KC * T + t * 4;
      const uint32_t* word = plan.bits[r0 / 32] + GRP * OG;
#pragma unroll
      for (int i = 0; i < OG; ++i) {
        // the stage's rows that output i takes; rows past nrows have no bits
        uint32_t b = (word[i] >> (r0 % 32)) & STAGE_BITS;
        while (b) {
          const int r = __ffs(b) - 1;
          b &= b - 1u;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const uint4 q = *reinterpret_cast<const uint4*>(stage + r * T + c * GT * 4);
            acc[i][4 * c] ^= q.x; acc[i][4 * c + 1] ^= q.y;
            acc[i][4 * c + 2] ^= q.z; acc[i][4 * c + 3] ^= q.w;
          }
        }
      }
      mbar_arrive(&empty[s]);
      if (++s == S) {
        s = 0;
        phase ^= 1u;
      }
    }

    if (bulk_out) {
      // Hand the sums to bulk stores, so that the group goes on to the
      // next tile while they drain: wait until the previous tile's bulk
      // stores have read the staging rows, fill them, make them visible
      // to the bulk copies, and let one thread issue one per output.
      if (t == 0) bulk_wait_read();
      group_sync<GRP>();
#pragma unroll
      for (int i = 0; i < OG; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c)
          *reinterpret_cast<uint4*>(mine + i * T + c * GT * 4 + t * 4) = make_uint4(
              acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2], acc[i][4 * c + 3]);
      fence_proxy_async();
      group_sync<GRP>();
      if (t == 0) {
        const int lanes = n4 - c0 < T ? static_cast<int>(n4 - c0) : T;
        for (int i = 0; i < OG && GRP * OG + i < m; ++i)
          bulk_store(out + (long long)(GRP * OG + i) * n4 + c0, mine + i * T, lanes * 4u,
                     accumulate);
        bulk_commit();
      }
    } else {
#pragma unroll
      for (int i = 0; i < OG; ++i) {
        if (GRP * OG + i >= m) break;
        uint32_t* orow = out + (long long)(GRP * OG + i) * n4;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const long long col = c0 + c * GT * 4 + t * 4;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (col + q < n4)
              orow[col + q] = accumulate ? orow[col + q] ^ acc[i][4 * c + q]
                                         : acc[i][4 * c + q];
        }
      }
    }
  }
  if (bulk_out && t == 0) bulk_wait_all();  // the staging rows outlive the reads
}

// Runs consume<MT, grp> with the group a template argument.
template <int MT, int GRP = 0>
__device__ __forceinline__ void consume_group(int grp, const Plan& plan, const uint32_t* ring,
                                              uint32_t* staging, uint64_t* full,
                                              uint64_t* empty, uint32_t* __restrict__ out,
                                              int nrows, int m, long long n4, bool bulk_out,
                                              bool accumulate) {
  if constexpr (GRP < GROUPS) {
    if (grp == GRP)
      consume<MT, GRP>(plan, ring, staging, full, empty, out, nrows, m, n4, bulk_out,
                       accumulate);
    else
      consume_group<MT, GRP + 1>(grp, plan, ring, staging, full, empty, out, nrows, m, n4,
                                 bulk_out, accumulate);
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS)
bitmatrix_xor_kernel(const __grid_constant__ Plan plan, const uint32_t* __restrict__ in,
                     uint32_t* __restrict__ out, int nrows, int m, long long n4, int bulk,
                     int bulk_out, int accumulate) {
  constexpr int T = GT * lanes_per_thread<MT>();
  extern __shared__ __align__(128) uint32_t ring[];  // [S][KC][T], then [MT][T] staging
  __shared__ __align__(8) uint64_t full[S], empty[S];

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    produce<T>(plan, in, ring, full, empty, nrows, n4, bulk != 0);
    return;
  }
  // broadcast from lane 0, so that the compiler knows it is the same
  // across the warp
  consume_group<MT>(__shfl_sync(0xffffffffu, (int)threadIdx.x / GT, 0), plan, ring,
                    ring + S * KC * T, full, empty, out, nrows, m, n4, bulk_out != 0,
                    accumulate != 0);
}

template <int MT>
int launch(const Plan& plan, const void* in, void* out, int nrows, int m, long long n4,
           int accumulate, cudaStream_t stream) {
  static_assert(MT % GROUPS == 0 && lanes_per_thread<MT>() % 4 == 0, "bad tile");
  constexpr int T = GT * lanes_per_thread<MT>();
  constexpr size_t smem = (size_t)(S * KC + MT) * T * sizeof(uint32_t);
  // per device: SMs x the blocks an SM holds, 0 until the first launch there
  static std::atomic<int> grid_cap[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int cap = dev < MAX_DEVICES ? grid_cap[dev].load(std::memory_order_acquire) : 0;
  if (cap == 0) {
    auto kernel = bitmatrix_xor_kernel<MT>;
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
  // as many blocks as fit, cut so that every block walks as many tiles
  const long long ntile = (n4 + T - 1) / T;
  const long long rounds = (ntile + cap - 1) / cap;
  const unsigned grid = (unsigned)((ntile + rounds - 1) / rounds);
  const int bulk = reinterpret_cast<uintptr_t>(in) % 16 == 0 && n4 % 4 == 0;
  const int bulk_out = reinterpret_cast<uintptr_t>(out) % 16 == 0 && n4 % 4 == 0;
  bitmatrix_xor_kernel<MT><<<grid, THREADS, smem, stream>>>(
      plan, static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), nrows, m, n4,
      bulk, bulk_out, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bitmatrix_xor_plan_bytes() { return static_cast<int>(sizeof(Plan)); }

// One launch: output tile `out` (its first row; `m` rows, at most mt)
// from the used input rows that `plan` names (`nrows` of them, indices
// into `in`, the first of the K input rows), with `plan` one of the
// host buffers gf_cuda.bitmatrix_table packs (sizeof(Plan) bytes).
// With `accumulate` the sums are XORed into `out`, else stored.
// Returns the launch's cudaGetLastError() (0 on success), or -1 for an
// mt that was not built.
extern "C" int bitmatrix_xor_launch(const void* in, void* out, const void* plan, int nrows,
                                    int m, int mt, long long n4, int accumulate,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  std::memcpy(&p, plan, sizeof(Plan));
  switch (mt) {
    case 8: return launch<8>(p, in, out, nrows, m, n4, accumulate, s);
    case 16: return launch<16>(p, in, out, nrows, m, n4, accumulate, s);
    case 32: return launch<32>(p, in, out, nrows, m, n4, accumulate, s);
    default: return -1;
  }
}
