// crush_straw2: CRUSH's straw2 bucket choice over a bucket row per lane,
// exact, for NVIDIA Hopper (sm_90a).
//
// Replaces the straw2 draw of the reference's CRUSH XLA programs:
// straw2_choose_approx (ceph_tpu/crush/mapper_jax.py:280) on flat maps and
// _straw2_rows (ceph_tpu/crush/mapper_jax_hier.py:189) on hierarchies.
// Those are no Pallas kernels: the TPU has no fast vector gather for the
// ln tables and keeps int64 out of its hot path, so they draw in f32 and
// flag lanes whose runner-up lies within an error budget for a host
// re-run.  Here the draw is the one bucket_straw2_choose defines
// (ceph_tpu/crush/mapper.py:175, reference:src/crush/mapper.c:302), bit
// for bit, so nothing is flagged:
//
//   for each item i of the lane's bucket, in order:
//     u    = hash32_3(x, item, r) & 0xffff
//     ln   = crush_ln(u) - 2^48                       (<= 0)
//     draw = w > 0 ? ln / w truncated toward zero : S64_MIN
//   the first maximum wins.
//
// Inputs: lanes x (uint32 bits in int32), rows (a bucket row per lane;
// rows outside [0, B) read row 0 or B-1, as the plain version does) and r
// (per lane: vary_r and indep make it lane-varying); the map's [B, I]
// int32 tables (items, 16.16 weights, child row, child type) and size [B];
// the ln tables as int64 (RH_LH_TBL, 258 entries, then LL_TBL, 256).
// Output per lane: the winning slot's item, child row and child type
// ([3, lanes] int32; slot 0, the padding, for a size-0 bucket) and
// empty (size 0).
//
// Bound: operations.  A draw is one rjenkins hash (five mix rounds of
// nine subtract-subtract-shift-xor lines), crush_ln (normalise, two
// table reads, a 64-bit multiply, a third table read) and an unsigned
// 64-bit divide, which Hopper has no instruction for: nvcc calls a
// subroutine for a dividend above 32 bits, which is nearly every draw
// (`gf_matmul_sweep --kernel crush_straw2 --sass` dumps the SASS that
// chip_smoke.py's INSTRUCTIONS_PER_DRAW counts).
// Bytes are 25 a lane plus the rows, which stay in L1/L2.
//
// Design, simple and right first: one thread per lane, its bucket row
// read from global memory, the 514 ln-table entries staged in shared
// memory once per block (the table reads are data dependent gathers).
// (x * rh) >> 48 needs 65 bits, but only its low byte is used, which the
// 64-bit wrapping product keeps.  The divide is by a positive 32-bit
// weight of a non-negative 49-bit value, so it is done unsigned.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRhLh = 258;
constexpr int kLnEntries = kRhLh + 256;
constexpr uint32_t kSeed = 1315423911u;

__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a = a - b - c; a ^= c >> 13;
  b = b - c - a; b ^= a << 8;
  c = c - a - b; c ^= b >> 13;
  a = a - b - c; a ^= c >> 12;
  b = b - c - a; b ^= a << 16;
  c = c - a - b; c ^= b >> 5;
  a = a - b - c; a ^= c >> 3;
  b = b - c - a; b ^= a << 10;
  c = c - a - b; c ^= b >> 15;
}

// reference:hash.c:48
__device__ __forceinline__ uint32_t hash32_3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t h = kSeed ^ a ^ b ^ c;
  uint32_t x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(c, x, h);
  mix(y, a, h);
  mix(b, x, h);
  mix(y, c, h);
  return h;
}

// 2^44 * log2(u + 1) in fixed point, u in [0, 0xffff] (reference:mapper.c:248)
__device__ __forceinline__ int64_t crush_ln(uint32_t u, const int64_t* ln) {
  uint32_t x = u + 1;
  int iexpon = 15;
  if (!(x & 0x18000u)) {
    int bits = __clz(x & 0x1FFFFu) - 16;  // 16 - bit_length
    x <<= bits;
    iexpon = 15 - bits;
  }
  int index1 = (x >> 8) << 1;
  uint64_t rh = static_cast<uint64_t>(ln[index1 - 256]);
  int64_t lh = ln[index1 + 1 - 256];
  uint32_t xl = static_cast<uint32_t>((static_cast<uint64_t>(x) * rh) >> 48) & 0xFFu;
  lh += ln[kRhLh + xl];
  return (static_cast<int64_t>(iexpon) << 44) + (lh >> 4);
}

__global__ void __launch_bounds__(kThreads)
crush_straw2_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ rows,
                    const int32_t* __restrict__ r, const int32_t* __restrict__ items,
                    const int32_t* __restrict__ weights,
                    const int32_t* __restrict__ child_row,
                    const int32_t* __restrict__ child_type,
                    const int32_t* __restrict__ size, const int64_t* __restrict__ ln,
                    int B, int I, long long lanes, int32_t* __restrict__ out,
                    bool* __restrict__ empty) {
  __shared__ int64_t s_ln[kLnEntries];
  for (int i = threadIdx.x; i < kLnEntries; i += kThreads) s_ln[i] = ln[i];
  __syncthreads();

  long long lane = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  uint32_t xv = static_cast<uint32_t>(x[lane]);
  uint32_t rv = static_cast<uint32_t>(r[lane]);
  int row = min(max(rows[lane], 0), B - 1);
  int n = size[row];
  const int32_t* it = items + static_cast<long long>(row) * I;
  const int32_t* wt = weights + static_cast<long long>(row) * I;

  int high = 0;
  int64_t high_draw = 0;
  for (int i = 0; i < n; ++i) {
    int32_t w = wt[i];
    int64_t draw = INT64_MIN;
    if (w > 0) {
      uint32_t u = hash32_3(xv, static_cast<uint32_t>(it[i]), rv) & 0xFFFFu;
      uint64_t neg_ln = (1ull << 48) - static_cast<uint64_t>(crush_ln(u, s_ln));
      draw = -static_cast<int64_t>(neg_ln / static_cast<uint32_t>(w));
    }
    if (i == 0 || draw > high_draw) {
      high = i;
      high_draw = draw;
    }
  }
  long long slot = static_cast<long long>(row) * I + high;
  out[lane] = it[high];
  out[lanes + lane] = child_row[slot];
  out[2 * lanes + lane] = child_type[slot];
  empty[lane] = n == 0;
}

}  // namespace

extern "C" int crush_straw2_ln_entries() { return kLnEntries; }

// Launches on `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int crush_straw2_launch(const void* x, const void* rows, const void* r,
                                   const void* items, const void* weights,
                                   const void* child_row, const void* child_type,
                                   const void* size, const void* ln, int B, int I,
                                   long long lanes, void* out, void* empty,
                                   void* stream) {
  if (lanes <= 0) return 0;
  long long blocks = (lanes + kThreads - 1) / kThreads;
  crush_straw2_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(r), static_cast<const int32_t*>(items),
      static_cast<const int32_t*>(weights), static_cast<const int32_t*>(child_row),
      static_cast<const int32_t*>(child_type), static_cast<const int32_t*>(size),
      static_cast<const int64_t*>(ln), B, I, lanes, static_cast<int32_t*>(out),
      static_cast<bool*>(empty));
  return static_cast<int>(cudaGetLastError());
}
