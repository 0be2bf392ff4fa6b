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
// Here one thread per lane runs the scalar mapper's own loops
// (ceph_tpu_torch/crush/mapper.py: crush_choose_firstn :225 with
// chooseleaf's inner call, recurse_tries, vary_r and stable;
// crush_choose_indep :358 with its UNDEF/NONE slots and r = rep +
// numrep * ftotal; bucket_straw2_choose :176), with modern tunables
// (no local retries) over straw2 buckets, as mapper_torch_hier.fused_rule
// admits them.  A lane draws only what its own placement needs, and its
// warp diverges only on the rare retry.
//
// State: the lane's out and out2 (at most kMaxWidth slots) in local
// memory, which L1 holds.  Tables: the take bucket's row (items, weights,
// reciprocals, child rows and types) and the 514 ln-table entries staged
// in shared memory once a block (24 bytes an item: 1.5 KB for a 64-item
// row, 15 KB for a 640-host root); a root of more than kMaxStaged items is
// read from global memory instead.  Deeper rows are read from global
// memory; the padded [B, I] tables are a few MB at most and sit in L2.
//
// Output: [lanes, width] int32 with CRUSH_ITEM_NONE holes: out2 for
// chooseleaf, otherwise out, as the step engine returns it.  The kernel
// also counts the draws it made (items of the rows it drew over; one
// atomicAdd a block into *draws), which is what these inputs need.
//
// Bound: operations, as crush_straw2's: the draws' integer work (hash,
// crush_ln, divide by reciprocal) at four warp instructions a clock per
// SM; chip_smoke.py multiplies the counted draws by the SASS a draw
// issues.  Bytes are 4 a lane in and 4 a slot out.  Tensor cores have no
// work here (no product of matrices), and TMA none either: a lane's reads
// are data-dependent gathers of a few bytes from rows that L1/L2 hold, and
// the one bulk read, the staged root row, is 1.5-15 KB a block.

#include <cstdint>
#include <cuda_runtime.h>

#include "crush_draw.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWidth = 32;
// items of a take row staged in shared memory, with the ln tables under 48 KB
constexpr int kMaxStaged = 1792;
constexpr int32_t kNone = 0x7FFFFFFF;   // CRUSH_ITEM_NONE
constexpr int32_t kUndef = 0x7FFFFFFE;  // CRUSH_ITEM_UNDEF
// the rule, as crush_cuda.crush_choose packs it
constexpr int kRuleInts = 11;

struct Rule {
  int take_row, firstn, leaf, numrep, width, tries, recurse_tries, want_type, vary_r,
      stable, depth;
};

struct Tables {
  const int32_t* items;
  const int32_t* weights;
  const uint64_t* recip;
  const int32_t* child_row;
  const int32_t* child_type;
  const int32_t* size;
  int I;
};

// the take row, staged or in global memory
struct Row {
  const int32_t* items;
  const int32_t* weights;
  const uint64_t* recip;
  const int32_t* child_row;
  const int32_t* child_type;
  int n;
};

enum Status { kHit, kEmpty, kDead };

struct Pick {
  int32_t item, row, type;
  Status status;
};

struct Lane {
  Tables t;
  Row root;
  int root_row;
  const int64_t* ln;
  const int32_t* reweight;
  int n_reweight;
  uint32_t x;
  int depth;
  unsigned long long draws;

  // retry_bucket's descent from `row` to the first item of want_type: kHit
  // with the item, its row and type; kEmpty at an empty bucket; kDead at
  // an item of another type that is no bucket (skip_rep), or past depth
  __device__ Pick descend(int row, uint32_t r, int want_type) {
    for (int level = 0; level <= depth; ++level) {
      int32_t item, crow, ctype;
      if (row == root_row) {
        if (root.n == 0) return {0, -1, 0, kEmpty};
        int s = crush::straw2_slot(root.items, root.weights, root.recip, root.n, x, r, ln);
        draws += root.n;
        item = root.items[s];
        crow = root.child_row[s];
        ctype = root.child_type[s];
      } else {
        int n = t.size[row];
        if (n == 0) return {0, -1, 0, kEmpty};
        long long base = static_cast<long long>(row) * t.I;
        int s = crush::straw2_slot(t.items + base, t.weights + base, t.recip + base, n, x,
                                   r, ln);
        draws += n;
        item = t.items[base + s];
        crow = t.child_row[base + s];
        ctype = t.child_type[base + s];
      }
      if (ctype == want_type) return {item, crow, ctype, kHit};
      if (item >= 0 || crow < 0) break;
      row = crow;
    }
    return {0, -1, 0, kDead};
  }

  __device__ bool out(int32_t item) {
    return crush::is_out(reweight, n_reweight, item, x);
  }
};

__device__ __forceinline__ bool holds(const int32_t* v, int n, int32_t item) {
  for (int i = 0; i < n; ++i)
    if (v[i] == item) return true;
  return false;
}

// chooseleaf's inner crush_choose_firstn: one rep (rep2) at type 0 below
// `row`, parent_r = sub_r, collisions against out2[0, outpos)
__device__ bool leaf_firstn(Lane& L, const Rule& R, int row, int rep2, uint32_t sub_r,
                            const int32_t* out2, int outpos, int32_t& leaf) {
  for (int ftotal = 0;;) {
    Pick p = L.descend(row, rep2 + sub_r + ftotal, 0);
    if (p.status == kDead) return false;
    bool reject = p.status == kEmpty, collide = false;
    if (!reject) {
      collide = holds(out2, outpos, p.item);
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
__device__ int choose_firstn(Lane& L, const Rule& R, int32_t* out, int32_t* out2) {
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
        collide = holds(out, outpos, item);
        if (!collide && R.leaf) {
          if (item < 0) {
            uint32_t sub_r = R.vary_r ? r >> (R.vary_r - 1) : 0;
            int32_t leaf;
            if (leaf_firstn(L, R, p.row, R.stable ? 0 : outpos, sub_r, out2, outpos, leaf))
              out2[outpos] = leaf;
            else
              reject = true;
          } else {
            out2[outpos] = item;
          }
        }
        if (!reject && !collide && p.type == 0) reject = L.out(item);
      }
      if (!reject && !collide) {
        out[outpos++] = item;
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
__device__ bool leaf_indep(Lane& L, const Rule& R, int row, int rep, uint32_t r,
                           int32_t& leaf) {
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

// crush_choose_indep from the take row, outpos 0, parent_r 0
__device__ void choose_indep(Lane& L, const Rule& R, int32_t* out, int32_t* out2) {
  for (int rep = 0; rep < R.width; ++rep) out[rep] = out2[rep] = kUndef;
  int left = R.width;
  for (int ftotal = 0; left > 0 && ftotal < R.tries; ++ftotal) {
    for (int rep = 0; rep < R.width; ++rep) {
      if (out[rep] != kUndef) continue;
      uint32_t r = rep + R.numrep * ftotal;
      Pick p = L.descend(L.root_row, r, R.want_type);
      if (p.status == kEmpty) continue;
      if (p.status == kDead) {
        out[rep] = out2[rep] = kNone;
        --left;
        continue;
      }
      if (holds(out, R.width, p.item)) continue;
      if (R.leaf) {
        if (p.item < 0) {
          int32_t leaf;
          if (!leaf_indep(L, R, p.row, rep, r, leaf)) {
            out2[rep] = kNone;
            continue;
          }
          out2[rep] = leaf;
        } else {
          out2[rep] = p.item;
        }
      }
      if (p.type == 0 && L.out(p.item)) continue;
      out[rep] = p.item;
      --left;
    }
  }
  for (int rep = 0; rep < R.width; ++rep) {
    if (out[rep] == kUndef) out[rep] = kNone;
    if (out2[rep] == kUndef) out2[rep] = kNone;
  }
}

__global__ void __launch_bounds__(kThreads)
crush_choose_kernel(const int32_t* __restrict__ x, Tables t, const int64_t* __restrict__ ln,
                    const int32_t* __restrict__ reweight, int n_reweight, Rule R,
                    int n_root, bool staged, long long lanes, int32_t* __restrict__ out,
                    unsigned long long* __restrict__ draws) {
  extern __shared__ int64_t smem[];
  int64_t* s_ln = smem;
  const long long base = static_cast<long long>(R.take_row) * t.I;
  for (int i = threadIdx.x; i < crush::kLnEntries; i += kThreads) s_ln[i] = ln[i];
  Row root{t.items + base, t.weights + base, t.recip + base, t.child_row + base,
           t.child_type + base, n_root};
  if (staged) {
    uint64_t* s_recip = reinterpret_cast<uint64_t*>(s_ln + crush::kLnEntries);
    int32_t* s_items = reinterpret_cast<int32_t*>(s_recip + n_root);
    int32_t* s_weights = s_items + n_root;
    int32_t* s_child_row = s_weights + n_root;
    int32_t* s_child_type = s_child_row + n_root;
    for (int i = threadIdx.x; i < n_root; i += kThreads) {
      s_recip[i] = root.recip[i];
      s_items[i] = root.items[i];
      s_weights[i] = root.weights[i];
      s_child_row[i] = root.child_row[i];
      s_child_type[i] = root.child_type[i];
    }
    root = Row{s_items, s_weights, s_recip, s_child_row, s_child_type, n_root};
  }
  __shared__ unsigned long long s_draws;
  if (threadIdx.x == 0) s_draws = 0;
  __syncthreads();

  long long lane = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned long long made = 0;
  if (lane < lanes) {
    Lane L{t, root, R.take_row, s_ln, reweight, n_reweight,
           static_cast<uint32_t>(x[lane]), R.depth, 0};
    int32_t o[kMaxWidth], o2[kMaxWidth];
    int32_t* dst = out + lane * R.width;
    if (R.firstn) {
      int placed = choose_firstn(L, R, o, o2);
      const int32_t* res = R.leaf ? o2 : o;
      for (int i = 0; i < R.width; ++i) dst[i] = i < placed ? res[i] : kNone;
    } else {
      choose_indep(L, R, o, o2);
      const int32_t* res = R.leaf ? o2 : o;
      for (int i = 0; i < R.width; ++i) dst[i] = res[i];
    }
    made = L.draws;
  }
  for (int off = 16; off > 0; off >>= 1) made += __shfl_xor_sync(0xFFFFFFFFu, made, off);
  if ((threadIdx.x & 31) == 0 && made) atomicAdd(&s_draws, made);
  __syncthreads();
  if (threadIdx.x == 0 && s_draws) atomicAdd(draws, s_draws);
}

}  // namespace

extern "C" int crush_choose_max_width() { return kMaxWidth; }

extern "C" int crush_choose_rule_ints() { return kRuleInts; }

// `rule` is kRuleInts host ints in Rule's order, `root_size` the take
// row's size (size[take_row]).  Adds the draws made to
// *draws.  Launches on `stream`; returns the launch's cudaError_t (0 on
// success; cudaErrorInvalidValue for a width above kMaxWidth).
extern "C" int crush_choose_launch(const void* x, const void* items, const void* weights,
                                   const void* recip, const void* child_row,
                                   const void* child_type, const void* size, int root_size,
                                   const void* ln, const void* reweight, int n_reweight,
                                   int I, long long lanes, const int* rule, void* out,
                                   void* draws, void* stream) {
  Rule R{rule[0], rule[1], rule[2], rule[3], rule[4], rule[5],
         rule[6], rule[7], rule[8], rule[9], rule[10]};
  if (R.width < 1 || R.width > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes <= 0) return 0;
  Tables t{static_cast<const int32_t*>(items), static_cast<const int32_t*>(weights),
           static_cast<const uint64_t*>(recip), static_cast<const int32_t*>(child_row),
           static_cast<const int32_t*>(child_type), static_cast<const int32_t*>(size), I};
  bool staged = root_size <= kMaxStaged;
  size_t smem = crush::kLnEntries * sizeof(int64_t) +
                (staged ? static_cast<size_t>(root_size) * 24 : 0);
  long long blocks = (lanes + kThreads - 1) / kThreads;
  crush_choose_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), t, static_cast<const int64_t*>(ln),
      static_cast<const int32_t*>(reweight), n_reweight, R, root_size, staged, lanes,
      static_cast<int32_t*>(out), static_cast<unsigned long long*>(draws));
  return static_cast<int>(cudaGetLastError());
}
