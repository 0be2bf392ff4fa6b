/* ctypes shim around the vendored ISA-L plain-C reference implementation.
 *
 * The reference tree ships ISA-L's portable C fallback at
 * reference:src/erasure-code/isa/isa-l/erasure_code/ec_base.c
 * (gf_mul / gf_inv / gf_gen_rs_matrix / gf_gen_cauchy1_matrix /
 * gf_invert_matrix / gf_vect_mul_init / ec_encode_data_base).  The loader
 * (ceph_tpu_torch/utils/isa_oracle.py) compiles THAT file, unmodified and
 * in place, into the same shared object as this shim — nothing is copied
 * into this repo — producing a genuinely independent parity-byte oracle
 * for the ISA plugin family (the non-regression contract of
 * reference:src/test/erasure-code/ceph_erasure_code_non_regression.cc:154).
 *
 * This shim only adapts calling conventions for ctypes: flat buffers in,
 * pointer arrays built here, plus the 10-line ec_init_tables loop whose
 * home translation unit (ec_highlevel_func.c) cannot be built without the
 * x86 asm kernels it dispatches to.
 */

#include <stdlib.h>
#include <string.h>

/* Entry points exported by the reference ec_base.c translation unit. */
extern unsigned char gf_mul(unsigned char a, unsigned char b);
extern unsigned char gf_inv(unsigned char a);
extern void gf_gen_rs_matrix(unsigned char *a, int m, int k);
extern void gf_gen_cauchy1_matrix(unsigned char *a, int m, int k);
extern int gf_invert_matrix(unsigned char *in_mat, unsigned char *out_mat,
                            const int n);
extern void gf_vect_mul_init(unsigned char c, unsigned char *tbl);
extern void ec_encode_data_base(int len, int srcs, int dests, unsigned char *v,
                                unsigned char **src, unsigned char **dest);

/* ec_init_tables (reference:.../ec_highlevel_func.c:33): expand each
 * coefficient into its 32-byte nibble table via the reference's own
 * gf_vect_mul_init.  Restated here because ec_highlevel_func.c also
 * defines the SSE/AVX dispatch wrappers whose .asm.s bodies we neither
 * want nor can assemble portably. */
static void init_tables(int k, int rows, const unsigned char *a,
                        unsigned char *g_tbls) {
  for (int i = 0; i < rows; i++)
    for (int j = 0; j < k; j++) {
      gf_vect_mul_init(*a++, g_tbls);
      g_tbls += 32;
    }
}

/* technique: 0 = reed_sol_van (gf_gen_rs_matrix), 1 = cauchy
 * (gf_gen_cauchy1_matrix) — the two ErasureCodeIsa matrix kinds
 * (reference:src/erasure-code/isa/ErasureCodeIsa.cc:409-412). */
static int gen_matrix(int technique, int k, int m, unsigned char *full) {
  if (k <= 0 || m <= 0 || k + m > 255)
    return -1;
  if (technique == 0)
    gf_gen_rs_matrix(full, k + m, k);
  else if (technique == 1)
    gf_gen_cauchy1_matrix(full, k + m, k);
  else
    return -2;
  return 0;
}

/* Writes the full (k+m) x k distribution matrix (identity on top). */
int oracle_gen_matrix(int technique, int k, int m, unsigned char *out) {
  return gen_matrix(technique, k, m, out);
}

/* Reference encode: data_flat is k rows of len bytes; parity_flat receives
 * m rows of len bytes, computed exactly as ErasureCodeIsa::encode_chunks
 * does — ec_init_tables over the parity block then ec_encode_data
 * (reference:src/erasure-code/isa/ErasureCodeIsa.cc:154,427), using the
 * portable ec_encode_data_base kernel. */
int oracle_encode(int technique, int k, int m, long long len,
                  const unsigned char *data_flat, unsigned char *parity_flat) {
  unsigned char full[255 * 255];
  if (gen_matrix(technique, k, m, full) != 0)
    return -1;
  unsigned char *tbls = (unsigned char *)malloc((size_t)32 * k * m);
  unsigned char **src = (unsigned char **)malloc(sizeof(char *) * k);
  unsigned char **dst = (unsigned char **)malloc(sizeof(char *) * m);
  if (!tbls || !src || !dst) {
    free(tbls); free(src); free(dst);
    return -3;
  }
  init_tables(k, m, full + (size_t)k * k, tbls);
  for (int j = 0; j < k; j++)
    src[j] = (unsigned char *)data_flat + (size_t)j * len;
  for (int l = 0; l < m; l++)
    dst[l] = parity_flat + (size_t)l * len;
  ec_encode_data_base((int)len, k, m, tbls, src, dst);
  free(tbls); free(src); free(dst);
  return 0;
}

/* Reference matrix inverse over GF(2^8) (gf_invert_matrix).  in/out are
 * n x n row-major; in is clobbered by the reference routine, so copy. */
int oracle_invert(const unsigned char *in, unsigned char *out, int n) {
  if (n <= 0 || n > 255)
    return -1;
  unsigned char *tmp = (unsigned char *)malloc((size_t)n * n);
  if (!tmp)
    return -3;
  memcpy(tmp, in, (size_t)n * n);
  int rc = gf_invert_matrix(tmp, out, n);
  free(tmp);
  return rc;
}

unsigned char oracle_gf_mul(unsigned char a, unsigned char b) {
  return gf_mul(a, b);
}

unsigned char oracle_gf_inv(unsigned char a) { return gf_inv(a); }
