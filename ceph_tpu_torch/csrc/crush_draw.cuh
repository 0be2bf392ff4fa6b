// crush_draw.cuh: the device functions of CRUSH's straw2 draw, shared by
// crush_straw2.cu (one draw over a bucket row per lane) and
// crush_choose.cu (a whole choose step per lane, a row's draws split
// over a tile of threads).
//
// hash32_2 / hash32_3 are rjenkins1 (reference:src/crush/hash.c:37, :48),
// crush_ln the fixed-point 2^44 * log2(u + 1) (reference:mapper.c:248),
// is_out the reweight rejection (reference:mapper.c:385), straw2_q one
// item's draw and straw2_slot the draw of bucket_straw2_choose
// (reference:mapper.c:302, ceph_tpu_torch/crush/mapper.py:176):
//
//   for each item i of the bucket, in order:
//     u    = hash32_3(x, item, r) & 0xffff
//     ln   = crush_ln(u) - 2^48                       (<= 0)
//     draw = w > 0 ? ln / w truncated toward zero : S64_MIN
//   the first maximum wins.
//
// The divide.  -ln = 2^48 - crush_ln(u) is a value n in [0, 2^48] and w a
// weight in [1, 2^31), and the draw is -(n / w).  Hopper has no 64-bit
// divide instruction: nvcc calls a subroutine of about 66 instructions for
// it, a quarter of the draw.  Here each weight has a reciprocal
// recip = floor((2^64 - 1) / w), computed once per map on the host
// (crush_torch.recip_table), and
//
//   q = umulhi64(n, recip);  if (n - q * w >= w) ++q;
//
// is n / w exactly.  Proof: let M = 2^64 and Q = floor(n / w).  recip <=
// (M - 1) / w < M / w, so n * recip / M < n / w and q <= Q.  recip >
// (M - 1) / w - 1, so n * recip / M > n / w - n (w + 1) / (w M) >=
// n / w - 2 n / M >= n / w - 2^-15 (w >= 1, n <= 2^48), and q >=
// floor(n / w - 2^-15) >= Q - 1.  So q is Q or Q - 1, and n - q * w (no
// overflow: q * w <= n) is at least w exactly when q = Q - 1.  For w = 1, recip = M - 1 and q =
// n - 1 for n >= 1 (0 for n = 0), which the correction brings to n.
// crush_torch.div_by_recip_plain is this arithmetic step by step.
//
// The draw compares quotients instead of draws: draw > high_draw is
// q < high_q, and a weight of 0 draws q = UINT64_MAX, above every q of a
// positive weight (<= 2^48), as S64_MIN is below every draw.  The first
// slot of the smallest q wins, as the first maximum draw does.

#pragma once

#include <cstdint>

namespace crush {

constexpr uint32_t kSeed = 1315423911u;
constexpr int kRhLh = 258;
// RH_LH_TBL (258 int64), then LL_TBL (256)
constexpr int kLnEntries = kRhLh + 256;

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

// reference:hash.c:37
__device__ __forceinline__ uint32_t hash32_2(uint32_t a, uint32_t b) {
  uint32_t h = kSeed ^ a ^ b;
  uint32_t x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(x, a, h);
  mix(b, y, h);
  return h;
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

// 2^44 * log2(u + 1) in fixed point, u in [0, 0xffff] (reference:mapper.c:248).
// (x * rh) >> 48 needs 65 bits, but only its low byte is used, which the
// 64-bit wrapping product keeps.
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

// n / w for n <= 2^48 and 1 <= w < 2^31, with recip = floor((2^64-1) / w)
__device__ __forceinline__ uint64_t div_by_recip(uint64_t n, uint32_t w, uint64_t recip) {
  uint64_t q = __umul64hi(n, recip);
  if (n - q * w >= w) ++q;
  return q;
}

// The quotient q = -draw of one item of positive weight w (recip its
// reciprocal): (2^48 - crush_ln(hash32_3(x, item, r) & 0xffff)) / w, at
// most 2^48.  Both kernels draw through it.
__device__ __forceinline__ uint64_t straw2_q(int32_t item, uint32_t w, uint64_t recip,
                                             uint32_t x, uint32_t r, const int64_t* ln) {
  uint32_t u = hash32_3(x, static_cast<uint32_t>(item), r) & 0xFFFFu;
  uint64_t neg_ln = (1ull << 48) - static_cast<uint64_t>(crush_ln(u, ln));
  return div_by_recip(neg_ln, w, recip);
}

// The winning slot of straw2 over a row's first n entries (slot 0 when n
// is 0), one item after the other.
__device__ __forceinline__ int straw2_slot(const int32_t* items, const int32_t* weights,
                                           const uint64_t* recip, int n, uint32_t x,
                                           uint32_t r, const int64_t* ln) {
  int high = 0;
  uint64_t high_q = ~0ull;
  for (int i = 0; i < n; ++i) {
    int32_t w = weights[i];
    uint64_t q = ~0ull;
    if (w > 0) q = straw2_q(items[i], static_cast<uint32_t>(w), recip[i], x, r, ln);
    if (q < high_q) {
      high = i;
      high_q = q;
    }
  }
  return high;
}

// reference:mapper.c:385: an item outside the reweight vector is out, a
// weight of 0x10000 or more is in, 0 is out, else in with probability
// w / 0x10000
__device__ __forceinline__ bool is_out(const int32_t* reweight, int n, int32_t item,
                                       uint32_t x) {
  if (item < 0 || item >= n) return true;
  int32_t w = reweight[item];
  if (w >= 0x10000) return false;
  if (w == 0) return true;
  return static_cast<int32_t>(hash32_2(x, static_cast<uint32_t>(item)) & 0xFFFFu) >= w;
}

}  // namespace crush
