// Single-thread flat straw2 CRUSH mapper — the honest compiled-C
// baseline for the placement-sim benchmark (the reference's
// crush_do_rule/CrushTester loop class: reference:src/crush/mapper.c:854,
// reference:src/crush/CrushTester.cc:648).
//
// Scope is deliberately the flat TAKE->CHOOSE_FIRSTN(type 0)->EMIT
// straw2 shape a bulk placement benchmark measures; the Python scalar
// mapper (ceph_tpu_torch/crush/mapper.py) covers the general map.  The
// fixed-point ln tables are generated at build time from
// ceph_tpu_torch/crush/ln_tables.py (the single source of truth) into
// crush_ln_tables.inc.  A copy of the reference package's
// native/crush_cpu.cc, loaded by utils/native_crush.py.

#include <cstdint>

#include "crush_ln_tables.inc"  // RH_LH_TBL[258], LL_TBL[256] (generated)

static const uint32_t HASH_SEED = 1315423911u;

static inline void mix(uint32_t &a, uint32_t &b, uint32_t &c) {
  a = (a - b - c) ^ (c >> 13);
  b = (b - c - a) ^ (a << 8);
  c = (c - a - b) ^ (b >> 13);
  a = (a - b - c) ^ (c >> 12);
  b = (b - c - a) ^ (a << 16);
  c = (c - a - b) ^ (b >> 5);
  a = (a - b - c) ^ (c >> 3);
  b = (b - c - a) ^ (a << 10);
  c = (c - a - b) ^ (b >> 15);
}

static inline uint32_t hash32_2(uint32_t a, uint32_t b) {
  uint32_t h = HASH_SEED ^ a ^ b;
  uint32_t x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(x, a, h);
  mix(b, y, h);
  return h;
}

static inline uint32_t hash32_3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t h = HASH_SEED ^ a ^ b ^ c;
  uint32_t x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(c, x, h);
  mix(y, a, h);
  mix(b, x, h);
  mix(y, c, h);
  return h;
}

// 2^44 * log2(x+1), fixed point (contract of reference:src/crush/mapper.c:248)
static inline int64_t crush_ln(uint32_t xin) {
  uint32_t x = xin + 1;
  int iexpon = 15;
  if (!(x & 0x18000)) {
    int bits = 0;
    uint32_t v = x & 0x1FFFF;
    int blen = 0;
    while (v) {
      blen++;
      v >>= 1;
    }
    bits = 16 - blen;
    x <<= bits;
    iexpon = 15 - bits;
  }
  uint32_t index1 = (x >> 8) << 1;
  uint64_t rh = RH_LH_TBL[index1 - 256];
  uint64_t lh = RH_LH_TBL[index1 + 1 - 256];
  uint64_t xl64 = ((uint64_t)x * rh) >> 48;
  int64_t result = (int64_t)iexpon << 44;
  lh += LL_TBL[xl64 & 0xFF];
  return result + (int64_t)(lh >> 4);
}

static inline int straw2_choose(const int32_t *items, const uint32_t *ws,
                                int n, int32_t bucket_id, uint32_t x,
                                uint32_t r) {
  int high = 0;
  int64_t high_draw = 0;
  for (int i = 0; i < n; i++) {
    int64_t draw;
    if (ws[i]) {
      uint32_t u = hash32_3(x, (uint32_t)items[i], r) & 0xFFFF;
      int64_t ln = crush_ln(u) - 0x1000000000000LL;
      draw = ln / (int64_t)ws[i];  // C trunc-toward-zero == div64_s64
    } else {
      draw = INT64_MIN;
    }
    if (i == 0 || draw > high_draw) {
      high = i;
      high_draw = draw;
    }
  }
  return high;
}

static inline bool is_out(const uint32_t *weight, int n_weight, int32_t item,
                          uint32_t x) {
  if (item >= n_weight) return true;
  uint32_t w = weight[item];
  if (w >= 0x10000) return false;
  if (w == 0) return true;
  return (hash32_2(x, (uint32_t)item) & 0xFFFF) >= w;
}

extern "C" {

// Maps xs[i] -> out[i*numrep .. i*numrep+numrep) (-1 = NONE hole) for a
// flat straw2 bucket; firstn semantics with choose_local_* disabled
// (the modern-tunables flat shape).
void crush_flat_firstn(const int32_t *items, const uint32_t *item_weights,
                       int n_items, int32_t bucket_id, const uint32_t *weight,
                       int n_weight, int max_devices, int numrep, int tries,
                       const uint32_t *xs, int64_t n_x, int32_t *out) {
  for (int64_t ix = 0; ix < n_x; ix++) {
    uint32_t x = xs[ix];
    int32_t *row = out + ix * numrep;
    int outpos = 0;
    for (int rep = 0; rep < numrep && outpos < numrep; rep++) {
      int ftotal = 0;
      bool skip = false;
      int32_t item = 0;
      for (;;) {
        uint32_t r = (uint32_t)(rep + ftotal);
        int idx = straw2_choose(items, item_weights, n_items, bucket_id, x, r);
        item = items[idx];
        if (item >= max_devices) {
          skip = true;
          break;
        }
        bool collide = false;
        for (int i = 0; i < outpos; i++)
          if (row[i] == item) {
            collide = true;
            break;
          }
        bool reject = !collide && is_out(weight, n_weight, item, x);
        if (reject || collide) {
          ftotal++;
          if (ftotal < tries) continue;
          skip = true;
          break;
        }
        break;
      }
      if (!skip) row[outpos++] = item;
    }
    for (int i = outpos; i < numrep; i++) row[i] = -1;  // CRUSH_ITEM_NONE
  }
}

}  // extern "C"
