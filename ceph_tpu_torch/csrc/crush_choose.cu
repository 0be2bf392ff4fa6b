// crush_choose: one rule's whole choose step per lane, exact, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the reference's CRUSH XLA programs for one TAKE -> CHOOSE ->
// EMIT rule: choose_firstn (ceph_tpu/crush/mapper_jax.py:336),
// choose_indep (:400), choose_firstn_hier and choose_indep_hier
// (ceph_tpu/crush/mapper_jax_hier.py:344, :467).  On the TPU those are
// masked lockstep loops over every lane, one draw program a try and a
// level; the port's step engine (crush/mapper_torch.py,
// crush/mapper_torch_hier.py) kept that shape around crush_straw2.cu, so
// each try drew over every lane, placed or not, with the collision and
// is_out checks as separate programs and a flag read back a try.
//
// Here a tile of G threads (G = 4, 8, 16 or 32, a template parameter, so
// every shuffle has a constant width) runs one lane through the scalar
// mapper's own loops (ceph_tpu_torch/crush/mapper.py: crush_choose_firstn
// :225 with chooseleaf's inner call, recurse_tries, vary_r and stable;
// crush_choose_indep :358 with its UNDEF/NONE slots and r = rep +
// numrep * ftotal; bucket_straw2_choose :176), with modern tunables (no
// local retries) over straw2 buckets, as mapper_torch_hier.fused_rule
// admits them.  A chained rule (the LRC rules: CHOOSE_INDEP over racks,
// then CHOOSELEAF_INDEP below each, as mapper_torch_hier.chain_rules
// reads them) is one launch a step: its first step from the take row,
// each later one from a root row per lane (crush_choose_roots_kernel,
// below).  All G threads take the lane's control flow together
// (reps, tries, descent, collision, is_out); only a row's draws are
// split among them.  A lane draws only what its own placement needs.
//
// A row's draw over the tile: thread t draws slots t, t + G, ... and
// keeps the key q << 15 | slot of its first strict minimum of q (the
// quotient crush_draw.cuh compares; a weight of 0 is q = 2^48 + 1, above
// every positive weight's q <= 2^48), and the tile takes the least key
// with __shfl_xor_sync.  The least key is the first slot of the least q,
// the scalar mapper's first maximum draw, so the result is bit for bit
// the one-thread walk's.  A row has fewer than 2^15 slots (the wrapper
// refuses a map with a wider row on the rule's path).
//
// What the design does about the one-thread walk's limits:
// 1. Divergence: one lane's retry stalled 31 others for a row of draws.
//    Now a warp holds 32 / G lanes, so a retry stalls 32 / G - 1 lanes
//    (none at G = 32), and a row of n items costs ceil(n / G) draws of
//    the tile's time instead of n.
// 2. Too few warps: phase 8's 65,536 lanes made 2,048 warps on 132 SMs;
//    a tile of G threads makes G times as many threads to hide the
//    draw's dependent integer chain (65,536 warps at G = 32).
// 3. Lane state: out and out2 (at most kMaxWidth slots) live in shared
//    memory, one pair a tile; a collision test is each thread checking
//    its own slots t, t + G, ... and one __any_sync over the tile, and
//    only the tile's thread 0 writes a placed slot.  No array is indexed
//    at run time in registers, so no local-memory stack frame is left.
// 4. Generic loads: the staged take row is an instantiation of its own
//    (kStaged), read only through pointers into the block's shared
//    memory, so its loads are LDS; a take row too wide to stage takes
//    the other instantiation, which reads it like a deeper row.
// 5. Scattered reads below the root: a deeper row is read by the tile's
//    threads at consecutive slots through the read-only path (__ldg), a
//    16-item host row in two sectors.
// 6. Staging repeated per block: blocks are persistent (as many as fit
//    resident, cudaOccupancyMaxActiveBlocksPerMultiprocessor times the
//    SMs) and loop over lanes, so each stages the take row (24 bytes an
//    item) and the 514 ln-table entries once, by a plain loop: the bulk
//    copy was not built, since a block stages once a launch.  Dynamic
//    shared memory (above 48 KB after cudaFuncSetAttribute) stages a take
//    row as wide as the device's opt-in limit allows, about 9,000 items.
//
// 7. A chain's later step runs crush_choose_indep once a bucket of the
//    previous step's output, so each lane has its own root: that kernel
//    reads the lane's root row from global memory like a deeper row and
//    stages nothing but the ln tables; a lane with no bucket (root -1:
//    the previous slot held NONE or a device) writes NONE and draws
//    nothing.
//
// Output: [lanes, width] int32 with CRUSH_ITEM_NONE holes: out2 for
// chooseleaf, otherwise out, as the step engine returns it.  The kernel
// also counts the draws it made (items of the rows a lane drew over,
// counted once a lane whatever G; one atomicAdd a block into *draws),
// which is what these inputs need, and the same count as a walk of one
// thread a lane makes.
//
// Bound: operations, as crush_straw2's: the counted draws times the SASS
// instructions of one draw (hash, crush_ln, divide by reciprocal), at
// four warp instructions a clock per SM; chip_smoke.py multiplies the
// counted draws by crush_straw2's 204.  The tile's shuffles, votes and
// shared-memory slots are overhead against that bound, not part of it,
// so the bound reads the same work whatever implements it.  Bytes are 4
// a lane in and 4 a slot out.  Tensor cores have no work here (no
// product of matrices), and TMA none either: a lane's reads are
// data-dependent gathers of a few bytes from rows that L1/L2 hold.

#include <cstdint>
#include <cuda_runtime.h>

#include "crush_draw.cuh"

namespace {

constexpr int kThreads = 1024;
// blocks an SM holds at least, which bounds the registers a thread
// (65,536 / (kThreads * kMinBlocks)); without it ptxas spills the lane's
// state to a local-memory stack frame
constexpr int kMinBlocks = 1;
constexpr int kMaxWidth = 32;
// a row's slots: the tile's key keeps the slot in its low 15 bits
constexpr int kSlotBits = 15;
constexpr int kMaxSlots = 1 << kSlotBits;
// q of a weight of 0: above every positive weight's q (<= 2^48)
constexpr unsigned long long kZeroWeightQ = (1ull << 48) + 1;
constexpr int32_t kNone = 0x7FFFFFFF;   // CRUSH_ITEM_NONE
constexpr int32_t kUndef = 0x7FFFFFFE;  // CRUSH_ITEM_UNDEF
// the rule, as crush_cuda.crush_choose packs it
constexpr int kRuleInts = 11;
// bytes a staged take-row item: recip, items, weights, child row, type
constexpr int kStagedItemBytes = 8 + 4 * 4;

struct Rule {
  int take_row, firstn, leaf, numrep, width, tries, recurse_tries, want_type, vary_r,
      stable, depth;
};

struct Tables {
  const int32_t* items;
  const int32_t* weights;
  const unsigned long long* recip;
  const int32_t* child_row;
  const int32_t* child_type;
  const int32_t* size;
  int I;
};

// A bucket row: in shared memory (kShared: the staged take row, plain
// loads the compiler makes LDS) or in global memory (through __ldg).
template <bool kShared>
struct Row {
  const int32_t* items;
  const int32_t* weights;
  const unsigned long long* recip;
  const int32_t* child_row;
  const int32_t* child_type;

  template <typename T>
  __device__ __forceinline__ static T at(const T* p, int i) {
    if constexpr (kShared) return p[i];
    else return __ldg(p + i);
  }
};

// Dynamic shared memory of a block: the draws' sum, the ln tables, the
// staged take row (kStaged) and each tile's out and out2.
__host__ __device__ constexpr size_t smem_bytes(bool staged, int n_root, int tiles, int width) {
  return sizeof(unsigned long long) + crush::kLnEntries * sizeof(int64_t) +
         (staged ? static_cast<size_t>(n_root) * kStagedItemBytes : 0) +
         static_cast<size_t>(tiles) * 2 * width * sizeof(int32_t);
}

enum Status { kHit, kEmpty, kDead };

struct Pick {
  int32_t item, row, type;
  Status status;
};

// One lane, as its tile of G threads sees it: every thread holds the
// same values; `t` is the thread's place in the tile.
template <int G, bool kStaged>
struct Lane {
  Tables tab;
  Row<kStaged> root;
  int n_root, root_row;
  const int64_t* ln;
  const int32_t* reweight;
  int n_reweight;
  uint32_t x;
  int depth;
  int t;
  unsigned mask;
  unsigned long long draws;

  // straw2 over a row of n > 0 items, split over the tile: thread t draws
  // slots t, t + G, ...; the least key q << 15 | slot is the first slot
  // of the least q
  template <bool kShared>
  __device__ __forceinline__ int draw(const Row<kShared>& row, int n, uint32_t r) {
    unsigned long long best = ~0ull;
    for (int i = t; i < n; i += G) {
      int32_t w = Row<kShared>::at(row.weights, i);
      unsigned long long q = kZeroWeightQ;
      if (w > 0)
        q = crush::straw2_q(Row<kShared>::at(row.items, i), static_cast<uint32_t>(w),
                            Row<kShared>::at(row.recip, i), x, r, ln);
      best = min(best, q << kSlotBits | static_cast<unsigned long long>(i));
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      best = min(best, __shfl_xor_sync(mask, best, off, G));
    return static_cast<int>(best & (kMaxSlots - 1));
  }

  // retry_bucket's descent from `row` to the first item of want_type: kHit
  // with the item, its row and type; kEmpty at an empty bucket; kDead at
  // an item of another type that is no bucket (skip_rep), or past depth
  __device__ __forceinline__ Pick descend(int row, uint32_t r, int want_type) {
    for (int level = 0; level <= depth; ++level) {
      int32_t item, crow, ctype;
      if (row == root_row) {
        if (n_root == 0) return {0, -1, 0, kEmpty};
        int s = draw(root, n_root, r);
        draws += n_root;
        item = Row<kStaged>::at(root.items, s);
        crow = Row<kStaged>::at(root.child_row, s);
        ctype = Row<kStaged>::at(root.child_type, s);
      } else {
        int n = __ldg(tab.size + row);
        if (n == 0) return {0, -1, 0, kEmpty};
        long long base = static_cast<long long>(row) * tab.I;
        Row<false> deep{tab.items + base, tab.weights + base, tab.recip + base,
                        tab.child_row + base, tab.child_type + base};
        int s = draw(deep, n, r);
        draws += n;
        item = __ldg(deep.items + s);
        crow = __ldg(deep.child_row + s);
        ctype = __ldg(deep.child_type + s);
      }
      if (ctype == want_type) return {item, crow, ctype, kHit};
      if (item >= 0 || crow < 0) break;
      row = crow;
    }
    return {0, -1, 0, kDead};
  }

  __device__ __forceinline__ bool out(int32_t item) const {
    return crush::is_out(reweight, n_reweight, item, x);
  }

  // whether v[0, n) holds item: each thread checks its own slots, one vote
  __device__ __forceinline__ bool holds(const int32_t* v, int n, int32_t item) const {
    bool found = false;
    for (int i = t; i < n; i += G) found |= v[i] == item;
    return __any_sync(mask, found);
  }

  // v[i] = item, written by the tile's thread 0, seen by the whole tile
  __device__ __forceinline__ void put(int32_t* v, int i, int32_t item) const {
    if (t == 0) v[i] = item;
    __syncwarp(mask);
  }
};

// chooseleaf's inner crush_choose_firstn: one rep (rep2) at type 0 below
// `row`, parent_r = sub_r, collisions against out2[0, outpos)
template <int G, bool S>
__device__ __forceinline__ bool leaf_firstn(Lane<G, S>& L, const Rule& R, int row, int rep2,
                                            uint32_t sub_r, const int32_t* out2, int outpos,
                                            int32_t& leaf) {
  for (int ftotal = 0;;) {
    Pick p = L.descend(row, rep2 + sub_r + ftotal, 0);
    if (p.status == kDead) return false;
    bool reject = p.status == kEmpty, collide = false;
    if (!reject) {
      collide = L.holds(out2, outpos, p.item);
      if (!collide && p.type == 0) reject = L.out(p.item);
    }
    if (!reject && !collide) {
      leaf = p.item;
      return true;
    }
    if (++ftotal >= R.recurse_tries) return false;
  }
}

// crush_choose_firstn from the take row, outpos 0, parent_r 0
template <int G, bool S>
__device__ __forceinline__ int choose_firstn(Lane<G, S>& L, const Rule& R, int32_t* out,
                                             int32_t* out2) {
  int outpos = 0;
  for (int rep = 0; rep < R.numrep && outpos < R.width; ++rep) {
    int32_t item = 0;
    for (int ftotal = 0;;) {
      uint32_t r = rep + ftotal;
      Pick p = L.descend(L.root_row, r, R.want_type);
      if (p.status == kDead) break;  // skip_rep
      bool reject = p.status == kEmpty, collide = false;
      if (!reject) {
        item = p.item;
        collide = L.holds(out, outpos, item);
        if (!collide && R.leaf) {
          if (item < 0) {
            uint32_t sub_r = R.vary_r ? r >> (R.vary_r - 1) : 0;
            int32_t leaf;
            if (leaf_firstn(L, R, p.row, R.stable ? 0 : outpos, sub_r, out2, outpos, leaf))
              L.put(out2, outpos, leaf);
            else
              reject = true;
          } else {
            L.put(out2, outpos, item);
          }
        }
        if (!reject && !collide && p.type == 0) reject = L.out(item);
      }
      if (!reject && !collide) {
        L.put(out, outpos++, item);
        break;
      }
      if (++ftotal >= R.tries) break;  // skip_rep
    }
  }
  return outpos;
}

// chooseleaf's inner crush_choose_indep: slot rep at type 0 below `row`,
// parent_r = r, its own recurse_tries rounds; no collision (its scope is
// its own slot, UNDEF on entry)
template <int G, bool S>
__device__ __forceinline__ bool leaf_indep(Lane<G, S>& L, const Rule& R, int row, int rep,
                                           uint32_t r, int32_t& leaf) {
  for (int ftotal = 0; ftotal < R.recurse_tries; ++ftotal) {
    Pick p = L.descend(row, rep + r + R.numrep * ftotal, 0);
    if (p.status == kDead) return false;
    if (p.status == kEmpty) continue;
    if (p.type == 0 && L.out(p.item)) continue;
    leaf = p.item;
    return true;
  }
  return false;
}

// crush_choose_indep from the take row, outpos 0, parent_r 0; UNDEF
// slots are left for the caller to write as NONE
template <int G, bool S>
__device__ __forceinline__ void choose_indep(Lane<G, S>& L, const Rule& R, int32_t* out,
                                             int32_t* out2) {
  for (int rep = L.t; rep < R.width; rep += G) out[rep] = out2[rep] = kUndef;
  __syncwarp(L.mask);
  int left = R.width;
  for (int ftotal = 0; left > 0 && ftotal < R.tries; ++ftotal) {
    for (int rep = 0; rep < R.width; ++rep) {
      if (out[rep] != kUndef) continue;
      uint32_t r = rep + R.numrep * ftotal;
      Pick p = L.descend(L.root_row, r, R.want_type);
      if (p.status == kEmpty) continue;
      if (p.status == kDead) {
        if (L.t == 0) out[rep] = out2[rep] = kNone;
        __syncwarp(L.mask);
        --left;
        continue;
      }
      if (L.holds(out, R.width, p.item)) continue;
      if (R.leaf) {
        if (p.item < 0) {
          int32_t leaf;
          if (!leaf_indep(L, R, p.row, rep, r, leaf)) {
            L.put(out2, rep, kNone);
            continue;
          }
          L.put(out2, rep, leaf);
        } else {
          L.put(out2, rep, p.item);
        }
      }
      if (p.type == 0 && L.out(p.item)) continue;
      L.put(out, rep, p.item);
      --left;
    }
  }
}

template <int G, bool kStaged>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
crush_choose_kernel(const int32_t* __restrict__ x, Tables tab, const int64_t* __restrict__ ln,
                    const int32_t* __restrict__ reweight, int n_reweight, Rule R, int n_root,
                    long long lanes, int32_t* __restrict__ out,
                    unsigned long long* __restrict__ draws) {
  constexpr int kTiles = kThreads / G;
  extern __shared__ int64_t smem[];
  unsigned long long* s_draws = reinterpret_cast<unsigned long long*>(smem);
  int64_t* s_ln = smem + 1;
  const long long base = static_cast<long long>(R.take_row) * tab.I;
  for (int i = threadIdx.x; i < crush::kLnEntries; i += kThreads) s_ln[i] = ln[i];
  int32_t* s_slots;
  Row<kStaged> root;
  if constexpr (kStaged) {
    unsigned long long* s_recip =
        reinterpret_cast<unsigned long long*>(s_ln + crush::kLnEntries);
    int32_t* s_items = reinterpret_cast<int32_t*>(s_recip + n_root);
    int32_t* s_weights = s_items + n_root;
    int32_t* s_child_row = s_weights + n_root;
    int32_t* s_child_type = s_child_row + n_root;
    for (int i = threadIdx.x; i < n_root; i += kThreads) {
      s_recip[i] = tab.recip[base + i];
      s_items[i] = tab.items[base + i];
      s_weights[i] = tab.weights[base + i];
      s_child_row[i] = tab.child_row[base + i];
      s_child_type[i] = tab.child_type[base + i];
    }
    root = Row<true>{s_items, s_weights, s_recip, s_child_row, s_child_type};
    s_slots = s_child_type + n_root;
  } else {
    root = Row<false>{tab.items + base, tab.weights + base, tab.recip + base,
                      tab.child_row + base, tab.child_type + base};
    s_slots = reinterpret_cast<int32_t*>(s_ln + crush::kLnEntries);
  }
  if (threadIdx.x == 0) *s_draws = 0;
  __syncthreads();

  const int tile = threadIdx.x / G;
  const int t = threadIdx.x % G;
  constexpr unsigned kTileMask = G == 32 ? 0xFFFFFFFFu : (1u << (G % 32)) - 1u;
  const unsigned mask = kTileMask << ((threadIdx.x & 31) & ~(G - 1));
  int32_t* o = s_slots + tile * 2 * R.width;
  int32_t* o2 = o + R.width;
  unsigned long long made = 0;
  for (long long lane = static_cast<long long>(blockIdx.x) * kTiles + tile; lane < lanes;
       lane += static_cast<long long>(gridDim.x) * kTiles) {
    Lane<G, kStaged> L{tab, root, n_root, R.take_row, s_ln, reweight, n_reweight,
                       static_cast<uint32_t>(__ldg(x + lane)), R.depth, t, mask, 0};
    int32_t* dst = out + lane * R.width;
    const int32_t* res = R.leaf ? o2 : o;
    if (R.firstn) {
      int placed = choose_firstn(L, R, o, o2);
      for (int i = t; i < R.width; i += G) dst[i] = i < placed ? res[i] : kNone;
    } else {
      choose_indep(L, R, o, o2);
      for (int i = t; i < R.width; i += G) dst[i] = res[i] == kUndef ? kNone : res[i];
    }
    made += L.draws;
    __syncwarp(mask);  // the slots' last reads before the next lane's writes
  }
  if (t == 0 && made) atomicAdd(s_draws, made);
  __syncthreads();
  if (threadIdx.x == 0 && *s_draws) atomicAdd(draws, *s_draws);
}

// A chain's later step: lane j runs crush_choose_indep from its own root
// row roots[j], outpos 0, parent_r 0, exactly as crush_choose_kernel runs
// it from the take row; a root of -1 writes NONE and draws nothing.
// Roots differ from lane to lane, so none is staged: a root row is read
// through __ldg like a deeper row.
template <int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
crush_choose_roots_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ roots,
                          Tables tab, const int64_t* __restrict__ ln,
                          const int32_t* __restrict__ reweight, int n_reweight, Rule R,
                          long long lanes, int32_t* __restrict__ out,
                          unsigned long long* __restrict__ draws) {
  constexpr int kTiles = kThreads / G;
  extern __shared__ int64_t smem[];
  unsigned long long* s_draws = reinterpret_cast<unsigned long long*>(smem);
  int64_t* s_ln = smem + 1;
  for (int i = threadIdx.x; i < crush::kLnEntries; i += kThreads) s_ln[i] = ln[i];
  int32_t* s_slots = reinterpret_cast<int32_t*>(s_ln + crush::kLnEntries);
  if (threadIdx.x == 0) *s_draws = 0;
  __syncthreads();

  const int tile = threadIdx.x / G;
  const int t = threadIdx.x % G;
  constexpr unsigned kTileMask = G == 32 ? 0xFFFFFFFFu : (1u << (G % 32)) - 1u;
  const unsigned mask = kTileMask << ((threadIdx.x & 31) & ~(G - 1));
  int32_t* o = s_slots + tile * 2 * R.width;
  int32_t* o2 = o + R.width;
  const int32_t* res = R.leaf ? o2 : o;
  unsigned long long made = 0;
  for (long long lane = static_cast<long long>(blockIdx.x) * kTiles + tile; lane < lanes;
       lane += static_cast<long long>(gridDim.x) * kTiles) {
    int32_t* dst = out + lane * R.width;
    const int row = __ldg(roots + lane);
    if (row < 0) {  // the tile's slots are untouched: no __syncwarp owed
      for (int i = t; i < R.width; i += G) dst[i] = kNone;
      continue;
    }
    const long long base = static_cast<long long>(row) * tab.I;
    Row<false> root{tab.items + base, tab.weights + base, tab.recip + base,
                    tab.child_row + base, tab.child_type + base};
    Lane<G, false> L{tab, root, __ldg(tab.size + row), row, s_ln, reweight, n_reweight,
                     static_cast<uint32_t>(__ldg(x + lane)), R.depth, t, mask, 0};
    choose_indep(L, R, o, o2);
    for (int i = t; i < R.width; i += G) dst[i] = res[i] == kUndef ? kNone : res[i];
    made += L.draws;
    __syncwarp(mask);  // the slots' last reads before the next lane's writes
  }
  if (t == 0 && made) atomicAdd(s_draws, made);
  __syncthreads();
  if (threadIdx.x == 0 && *s_draws) atomicAdd(draws, *s_draws);
}

struct Args {
  const int32_t* x;
  const int32_t* roots;  // null: every lane from the take row
  Tables tab;
  const int64_t* ln;
  const int32_t* reweight;
  int n_reweight;
  Rule R;
  int n_root;
  long long lanes;
  int32_t* out;
  unsigned long long* draws;
};

// Persistent blocks: as many as fit resident on the device, no more
// than the lanes need.
template <int G, typename Kernel>
cudaError_t persistent_blocks(Kernel kernel, size_t smem, long long lanes, unsigned* blocks) {
  constexpr int kTiles = kThreads / G;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int device, sms, per_sm;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  long long n = (lanes + kTiles - 1) / kTiles;
  if (n > static_cast<long long>(per_sm) * sms) n = static_cast<long long>(per_sm) * sms;
  *blocks = static_cast<unsigned>(n < 1 ? 1 : n);
  return cudaSuccess;
}

template <int G, bool kStaged>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = crush_choose_kernel<G, kStaged>;
  unsigned blocks;
  cudaError_t err = persistent_blocks<G>(kernel, smem, a.lanes, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(
      a.x, a.tab, a.ln, a.reweight, a.n_reweight, a.R, a.n_root, a.lanes, a.out, a.draws);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_roots(const Args& a, cudaStream_t stream) {
  auto kernel = crush_choose_roots_kernel<G>;
  size_t smem = smem_bytes(false, 0, kThreads / G, a.R.width);
  unsigned blocks;
  cudaError_t err = persistent_blocks<G>(kernel, smem, a.lanes, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(a.x, a.roots, a.tab, a.ln, a.reweight,
                                             a.n_reweight, a.R, a.lanes, a.out, a.draws);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_tile(const Args& a, cudaStream_t stream) {
  if (a.roots) return launch_roots<G>(a, stream);
  int device, optin;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  constexpr int kTiles = kThreads / G;
  size_t staged = smem_bytes(true, a.n_root, kTiles, a.R.width);
  if (staged <= static_cast<size_t>(optin)) return launch<G, true>(a, staged, stream);
  return launch<G, false>(a, smem_bytes(false, a.n_root, kTiles, a.R.width), stream);
}

}  // namespace

extern "C" int crush_choose_max_width() { return kMaxWidth; }

extern "C" int crush_choose_max_slots() { return kMaxSlots; }

extern "C" int crush_choose_rule_ints() { return kRuleInts; }

// `rule` is kRuleInts host ints in Rule's order, `root_size` the take
// row's size (size[take_row]), or with `roots` the most items of a row
// below them, `tile` the threads a lane (4, 8, 16 or 32).  `roots` is
// null, or int32 [lanes] rows that each lane's indep choose starts from
// (-1: none; the rule's take_row is then not read).  Adds the draws made
// to *draws.  Launches on `stream`; returns the launch's cudaError_t (0
// on success; cudaErrorInvalidValue for a width above kMaxWidth, a row
// of kMaxSlots items or more, firstn with roots, or another tile).
extern "C" int crush_choose_launch(const void* x, const void* roots, const void* items,
                                   const void* weights, const void* recip,
                                   const void* child_row, const void* child_type,
                                   const void* size, int root_size, const void* ln,
                                   const void* reweight, int n_reweight, int I,
                                   long long lanes, const int* rule, void* out, void* draws,
                                   int tile, void* stream) {
  Rule R{rule[0], rule[1], rule[2], rule[3], rule[4], rule[5],
         rule[6], rule[7], rule[8], rule[9], rule[10]};
  if (R.width < 1 || R.width > kMaxWidth || root_size < 0 || root_size >= kMaxSlots ||
      (roots && R.firstn))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes <= 0) return 0;
  Args a{static_cast<const int32_t*>(x),
         static_cast<const int32_t*>(roots),
         Tables{static_cast<const int32_t*>(items), static_cast<const int32_t*>(weights),
                static_cast<const unsigned long long*>(recip),
                static_cast<const int32_t*>(child_row),
                static_cast<const int32_t*>(child_type), static_cast<const int32_t*>(size), I},
         static_cast<const int64_t*>(ln), static_cast<const int32_t*>(reweight), n_reweight,
         R, root_size, lanes, static_cast<int32_t*>(out),
         static_cast<unsigned long long*>(draws)};
  auto s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 4: return static_cast<int>(launch_tile<4>(a, s));
    case 8: return static_cast<int>(launch_tile<8>(a, s));
    case 16: return static_cast<int>(launch_tile<16>(a, s));
    case 32: return static_cast<int>(launch_tile<32>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
