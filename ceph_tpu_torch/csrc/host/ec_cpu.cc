// Host erasure-code engine of ceph_tpu_torch: the native C lane and the
// failover replay engine of the OSD EC stack, and crc32c.
//
// Counterpart of native/ec_cpu.cc, cut to the entry points the port
// calls (ceph_tpu_torch/utils/native.py): gf8_encode_flat /
// gf16_encode_flat, gf8_encode_stripes, and crc32c_sw / crc32c_table.  Portable C++ (auto-vectorized by -O3
// -march=native; GFNI + AVX-512 where the host has them), GF(2^8) and
// GF(2^16) by the same shift-xor doubling scheme as the device kernels,
// so every engine produces identical bytes by construction.
//
// Exposed with C linkage for ctypes.

#include <cstdint>
#include <cstring>

#if defined(__GFNI__) && defined(__AVX512BW__) && defined(__AVX512F__)
#include <immintrin.h>
#define EC_CPU_GFNI 1
#endif

namespace {

// GF(2^8), poly 0x11d — lane-parallel double on uint64 (8 byte lanes)
static inline uint64_t gf8_double64(uint64_t x) {
  uint64_t high = (x >> 7) & 0x0101010101010101ULL;
  return ((x & 0x7f7f7f7f7f7f7f7fULL) << 1) ^ (high * 0x1dULL);
}

#ifdef EC_CPU_GFNI
// GFNI path: multiply-by-constant in GF(2^8)/0x11d expressed as an 8x8
// bit-matrix for vgf2p8affineqb (the ISA-L-class technique; the fixed
// gf2p8mulb polynomial is 0x11b, so the affine form is what makes the
// 0x11d field natively executable).  64 bytes per instruction on zmm.
static inline uint8_t gf8_mul1(uint8_t a, uint8_t b) {
  uint8_t p = 0;
  while (b) {
    if (b & 1) p ^= a;
    b >>= 1;
    a = (uint8_t)((a << 1) ^ ((a & 0x80) ? 0x1d : 0));
  }
  return p;
}

// row for output bit j = mask of source bits feeding it; stored at
// byte (7-j) of the matrix qword (verified against _mm_gf2p8affine)
static uint64_t gf8_affine_matrix(uint8_t c) {
  uint8_t p[8];
  for (int k = 0; k < 8; ++k) p[k] = gf8_mul1(c, (uint8_t)(1 << k));
  uint64_t A = 0;
  for (int j = 0; j < 8; ++j) {
    uint8_t row = 0;
    for (int k = 0; k < 8; ++k) row |= (uint8_t)(((p[k] >> j) & 1) << k);
    A |= ((uint64_t)row) << (8 * (7 - j));
  }
  return A;
}

// parity[i] ^= mul(matrix[i][j], data[j]) for all i, one data pass.
// aff: per-cell affine qwords [m*k]; n % 64 handled with a tail buffer.
static void gf8_encode_gfni(const uint64_t* aff, int k, int m,
                            const uint8_t* const* data,
                            uint8_t* const* parity, int64_t n) {
  const int64_t body = n & ~63LL;
  for (int64_t off = 0; off < body; off += 64) {
    __m512i acc[8];
    for (int i = 0; i < m; ++i) acc[i] = _mm512_setzero_si512();
    for (int j = 0; j < k; ++j) {
      __m512i src = _mm512_loadu_si512(
          (const void*)(data[j] + off));
      for (int i = 0; i < m; ++i) {
        uint64_t A = aff[i * k + j];
        if (!A) continue;
        acc[i] = _mm512_xor_si512(
            acc[i], _mm512_gf2p8affine_epi64_epi8(
                        src, _mm512_set1_epi64((long long)A), 0));
      }
    }
    for (int i = 0; i < m; ++i)
      _mm512_storeu_si512((void*)(parity[i] + off), acc[i]);
  }
  if (body < n) {  // tail: pad into a 64B buffer
    alignas(64) uint8_t sbuf[64], pbuf[8][64];
    for (int i = 0; i < m; ++i) std::memset(pbuf[i], 0, 64);
    for (int j = 0; j < k; ++j) {
      std::memset(sbuf, 0, 64);
      std::memcpy(sbuf, data[j] + body, (size_t)(n - body));
      __m512i src = _mm512_load_si512((const void*)sbuf);
      for (int i = 0; i < m; ++i) {
        uint64_t A = aff[i * k + j];
        if (!A) continue;
        __m512i acc = _mm512_load_si512((const void*)pbuf[i]);
        acc = _mm512_xor_si512(
            acc, _mm512_gf2p8affine_epi64_epi8(
                     src, _mm512_set1_epi64((long long)A), 0));
        _mm512_store_si512((void*)pbuf[i], acc);
      }
    }
    for (int i = 0; i < m; ++i)
      std::memcpy(parity[i] + body, pbuf[i], (size_t)(n - body));
  }
}
#endif  // EC_CPU_GFNI

static inline uint64_t gf16_double64(uint64_t x) {
  uint64_t high = (x >> 15) & 0x0001000100010001ULL;
  return ((x & 0x7fff7fff7fff7fffULL) << 1) ^ (high * 0x100bULL);
}

}  // namespace

extern "C" {

// parity[m][n] = matrix[m][k] (GF(2^8) elements) * data rows; n % 8 == 0.
// data: k pointers to n-byte chunks; parity: m pointers to n-byte chunks.
void gf8_encode(const int* matrix, int k, int m, const uint8_t* const* data,
                uint8_t* const* parity, int64_t n) {
#ifdef EC_CPU_GFNI
  if (m <= 8) {
    uint64_t aff[32 * 8];
    for (int i = 0; i < m; ++i)
      for (int j = 0; j < k; ++j)
        aff[i * k + j] = gf8_affine_matrix((uint8_t)matrix[i * k + j]);
    gf8_encode_gfni(aff, k, m, data, parity, n);
    return;
  }
#endif
  // powers[j][b] = 2^b * data[j], built lazily per 8-byte block to stay in
  // registers/cache: process in blocks of BLK bytes.
  constexpr int64_t BLK = 4096;
  uint64_t powbuf[8][BLK / 8];
  for (int64_t off = 0; off < n; off += BLK) {
    int64_t len = (n - off < BLK) ? (n - off) : BLK;
    int64_t words = len / 8;
    // zero parity accumulators for this block
    for (int i = 0; i < m; ++i) std::memset(parity[i] + off, 0, len);
    for (int j = 0; j < k; ++j) {
      // which powers of 2 does column j need?
      int needed = 0;
      for (int i = 0; i < m; ++i) needed |= matrix[i * k + j];
      if (!needed) continue;
      const uint64_t* src = reinterpret_cast<const uint64_t*>(data[j] + off);
      int maxb = 0;
      for (int b = 7; b >= 0; --b)
        if (needed & (1 << b)) { maxb = b; break; }
      // build doubling chain
      for (int64_t w = 0; w < words; ++w) powbuf[0][w] = src[w];
      for (int b = 1; b <= maxb; ++b)
        for (int64_t w = 0; w < words; ++w)
          powbuf[b][w] = gf8_double64(powbuf[b - 1][w]);
      for (int i = 0; i < m; ++i) {
        int c = matrix[i * k + j];
        if (!c) continue;
        uint64_t* dst = reinterpret_cast<uint64_t*>(parity[i] + off);
        for (int b = 0; b <= maxb; ++b)
          if (c & (1 << b))
            for (int64_t w = 0; w < words; ++w) dst[w] ^= powbuf[b][w];
      }
    }
  }
}

// Flat-layout convenience wrapper: data [k*n], parity out [m*n].
void gf8_encode_flat(const int* matrix, int k, int m, const uint8_t* data,
                     uint8_t* parity, int64_t n) {
  const uint8_t* dptr[32];
  uint8_t* pptr[32];
  for (int j = 0; j < k; ++j) dptr[j] = data + j * n;
  for (int i = 0; i < m; ++i) pptr[i] = parity + i * n;
  gf8_encode(matrix, k, m, dptr, pptr, n);
}

// Fused stripe-layout encode: one pass over the client buffer produces
// the per-shard buffers (the OSD's deliverable) AND the parity — no
// separate transpose pass re-reading the data (the codec
// stack's hot entry; ECUtil::encode's per-stripe loop collapsed).
// in: [S, k, cs] stripes; shards: flat [(k+m), S*cs] output whose rows
// are the shard buffers. cs % 8 == 0.
void gf8_encode_stripes(const int* matrix, int k, int m, int64_t S,
                        int64_t cs, const uint8_t* in, uint8_t* shards) {
  const int64_t shard_len = S * cs;
  const uint8_t* dptr[32];
  uint8_t* pptr[32];
#ifdef EC_CPU_GFNI
  if (m <= 8) {
    // affine table built ONCE for the whole batch (building
    // it per stripe cost as much as the vector work at small chunks)
    uint64_t aff[32 * 8];
    for (int i = 0; i < m; ++i)
      for (int j = 0; j < k; ++j)
        aff[i * k + j] = gf8_affine_matrix((uint8_t)matrix[i * k + j]);
    for (int64_t s = 0; s < S; ++s) {
      const uint8_t* base = in + s * k * cs;
      for (int j = 0; j < k; ++j) {
        dptr[j] = base + j * cs;
        std::memcpy(shards + j * shard_len + s * cs, dptr[j], cs);
      }
      for (int i = 0; i < m; ++i)
        pptr[i] = shards + (k + i) * shard_len + s * cs;
      gf8_encode_gfni(aff, k, m, dptr, pptr, cs);
    }
    return;
  }
#endif
  for (int64_t s = 0; s < S; ++s) {
    const uint8_t* base = in + s * k * cs;
    for (int j = 0; j < k; ++j) {
      dptr[j] = base + j * cs;
      std::memcpy(shards + j * shard_len + s * cs, dptr[j], cs);
    }
    for (int i = 0; i < m; ++i)
      pptr[i] = shards + (k + i) * shard_len + s * cs;
    gf8_encode(matrix, k, m, dptr, pptr, cs);
  }
}

// GF(2^16) variant (elements little-endian uint16; n bytes, n % 8 == 0)
void gf16_encode_flat(const int* matrix, int k, int m, const uint8_t* data,
                      uint8_t* parity, int64_t n) {
  int64_t words = n / 8;
  for (int i = 0; i < m; ++i) {
    uint64_t* dst = reinterpret_cast<uint64_t*>(parity + i * n);
    std::memset(dst, 0, n);
    for (int j = 0; j < k; ++j) {
      int c = matrix[i * k + j];
      if (!c) continue;
      const uint64_t* src = reinterpret_cast<const uint64_t*>(data + j * n);
      for (int64_t w = 0; w < words; ++w) {
        uint64_t acc = 0, p = src[w];
        for (int b = 0; b < 16; ++b) {
          if (c & (1 << b)) acc ^= p;
          p = gf16_double64(p);
        }
        dst[w] ^= acc;
      }
    }
  }
}

}  // extern "C"

// crc32c (Castagnoli, reflected poly 0x82F63B78), slicing-by-8.
// Same semantics as the reference's ceph_crc32c(crc, data, len): the seed is
// used as-is with no pre/post inversion (callers conventionally pass -1), so
// crcs compose: crc(a+b) = crc32c(crc32c(seed, a), b).
// reference:src/common/crc32c.h / common/crc32c_sctp.c (software path).
namespace {

struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int j = 0; j < 8; ++j) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xff];
  }
};
static const Crc32cTables kCrcTab;

}  // namespace

extern "C" {

uint32_t crc32c_sw(uint32_t crc, const uint8_t* data, int64_t n) {
#if defined(__SSE4_2__)
  // hardware CRC32C (SSE4.2 crc32 instruction): the exact Castagnoli
  // reflected polynomial with the same raw-state semantics as the
  // table path below (no pre/post inversion), so the two compose and
  // cross-check bit-identically (pinned by tests/test_torch_ec_util.py).
  // This is the per-frame checksum on every messenger hop — at table
  // speed (~1.5 GB/s) it dominated the zero-copy stack round trip;
  // the instruction runs at tens of GB/s (ceph's crc32c-intel path,
  // reference:src/common/crc32c_intel_fast.c).
  uint64_t c64 = crc;
  while (n >= 8) {
    uint64_t word;
    std::memcpy(&word, data, 8);
    c64 = __builtin_ia32_crc32di(c64, word);
    data += 8;
    n -= 8;
  }
  crc = (uint32_t)c64;
  while (n-- > 0) crc = __builtin_ia32_crc32qi(crc, *data++);
  return crc;
#else
  const uint32_t (*T)[256] = kCrcTab.t;
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  while (n >= 8) {
    uint64_t word;
    std::memcpy(&word, data, 8);
    word ^= crc;
    crc = T[7][word & 0xff] ^ T[6][(word >> 8) & 0xff] ^
          T[5][(word >> 16) & 0xff] ^ T[4][(word >> 24) & 0xff] ^
          T[3][(word >> 32) & 0xff] ^ T[2][(word >> 40) & 0xff] ^
          T[1][(word >> 48) & 0xff] ^ T[0][(word >> 56) & 0xff];
    data += 8;
    n -= 8;
  }
#endif  // big-endian hosts take the bytewise loop for all input
  while (n-- > 0) crc = (crc >> 8) ^ T[0][(crc ^ *data++) & 0xff];
  return crc;
#endif
}

// table-path reference, exported so the test suite can cross-check the
// hardware instruction against the software tables on any input
uint32_t crc32c_table(uint32_t crc, const uint8_t* data, int64_t n) {
  const uint32_t (*T)[256] = kCrcTab.t;
  while (n-- > 0) crc = (crc >> 8) ^ T[0][(crc ^ *data++) & 0xff];
  return crc;
}

}  // extern "C"
