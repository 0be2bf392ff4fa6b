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
// (ceph_tpu/crush/mapper.py:176, reference:src/crush/mapper.c:302), bit
// for bit, so nothing is flagged (crush_draw.cuh holds the draw).  The
// CUDA lanes of a single-step rule take crush_choose.cu, which runs the
// whole choose step per lane; this kernel serves the chained (LRC) rules'
// step engine and the rules crush_choose does not take.
//
// Inputs: lanes x (uint32 bits in int32), rows (a bucket row per lane;
// rows outside [0, B) read row 0 or B-1, as the plain version does) and r
// (per lane: vary_r and indep make it lane-varying); the map's [B, I]
// int32 tables (items, 16.16 weights, child row, child type), the
// weights' reciprocals ([B, I] uint64, crush_torch.recip_table) and size
// [B]; the ln tables as int64 (RH_LH_TBL, 258 entries, then LL_TBL, 256).
// Output per lane: the winning slot's item, child row and child type
// ([3, lanes] int32; slot 0, the padding, for a size-0 bucket) and
// empty (size 0).
//
// Bound: operations.  A draw is one rjenkins hash (five mix rounds of
// nine subtract-subtract-shift-xor lines), crush_ln (normalise, two
// table reads, a 64-bit multiply, a third table read) and the divide by
// reciprocal (a 64-bit high product and one correction), all integer
// work on the ALU and FMA pipes; chip_smoke.py counts the SASS a draw
// issues (INSTRUCTIONS_PER_DRAW, from `gf_matmul_sweep --kernel
// crush_straw2 --sass`) at four warp instructions a clock per SM.  Bytes
// are 25 a lane plus the rows, which stay in L1/L2.
//
// Design: one thread per lane, its bucket row read from global memory
// (the rows are small and shared by many lanes, so they sit in L1/L2),
// the 514 ln-table entries staged in shared memory once per block (the
// table reads are data dependent gathers).  The divide is the
// reciprocal multiply of crush_draw.cuh: a plain 64-bit divide makes nvcc
// call its divide subroutine, about 66 of 260 instructions a draw.

#include <cstdint>
#include <cuda_runtime.h>

#include "crush_draw.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
crush_straw2_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ rows,
                    const int32_t* __restrict__ r, const int32_t* __restrict__ items,
                    const int32_t* __restrict__ weights,
                    const uint64_t* __restrict__ recip,
                    const int32_t* __restrict__ child_row,
                    const int32_t* __restrict__ child_type,
                    const int32_t* __restrict__ size, const int64_t* __restrict__ ln,
                    int B, int I, long long lanes, int32_t* __restrict__ out,
                    bool* __restrict__ empty) {
  __shared__ int64_t s_ln[crush::kLnEntries];
  for (int i = threadIdx.x; i < crush::kLnEntries; i += kThreads) s_ln[i] = ln[i];
  __syncthreads();

  long long lane = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  int row = min(max(rows[lane], 0), B - 1);
  int n = size[row];
  long long base = static_cast<long long>(row) * I;
  int high = crush::straw2_slot(items + base, weights + base, recip + base, n,
                                static_cast<uint32_t>(x[lane]),
                                static_cast<uint32_t>(r[lane]), s_ln);
  out[lane] = items[base + high];
  out[lanes + lane] = child_row[base + high];
  out[2 * lanes + lane] = child_type[base + high];
  empty[lane] = n == 0;
}

}  // namespace

extern "C" int crush_straw2_ln_entries() { return crush::kLnEntries; }

// Launches on `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int crush_straw2_launch(const void* x, const void* rows, const void* r,
                                   const void* items, const void* weights,
                                   const void* recip, const void* child_row,
                                   const void* child_type, const void* size,
                                   const void* ln, int B, int I, long long lanes,
                                   void* out, void* empty, void* stream) {
  if (lanes <= 0) return 0;
  long long blocks = (lanes + kThreads - 1) / kThreads;
  crush_straw2_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(r), static_cast<const int32_t*>(items),
      static_cast<const int32_t*>(weights), static_cast<const uint64_t*>(recip),
      static_cast<const int32_t*>(child_row), static_cast<const int32_t*>(child_type),
      static_cast<const int32_t*>(size), static_cast<const int64_t*>(ln), B, I, lanes,
      static_cast<int32_t*>(out), static_cast<bool*>(empty));
  return static_cast<int>(cudaGetLastError());
}
