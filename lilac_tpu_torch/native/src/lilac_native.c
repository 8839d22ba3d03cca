/* lilac_tpu_torch native runtime: host-side hot loops that are inherently
 * sequential (the NPB makea random stream, the Benes cycle-walk colouring,
 * the MatrixMarket body parser), kept in C. The port's own copy of the
 * routines its paths use;
 * exposed through ctypes (lilac_tpu_torch/native/__init__.py), everything
 * returns into caller-allocated numpy buffers.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <math.h>

/* ---------------- NPB randlc (2^46 LCG, common/randi8.f) -------------- */

#define NPB_A 1220703125ull
#define MASK46 ((1ull << 46) - 1)

/* Phase-1 of makea (cg.f:707-720): per-row sparse random vectors via
 * rejection sampling. Returns total number of stored (pos, val) pairs.
 * nzv[na], pos[na*(nonzer+1)] (1-based), val[same]. */
long npb_triples(long na, int nonzer, int32_t* nzv, int64_t* pos, double* val) {
  uint64_t x = 314159265ull; /* tran, cg.f:186 */
  x = (x * NPB_A) & MASK46;  /* zeta = randlc(...) consumed once, cg.f:188 */
  long nn1 = 1;
  while (nn1 < na) nn1 *= 2;
  int shift_bits = 46 - (int)(log2((double)nn1) + 0.5);
  long w = 0;
  long* row_pos = (long*)malloc(sizeof(long) * (nonzer + 1));
  double* row_val = (double*)malloc(sizeof(double) * (nonzer + 1));
  for (long iouter = 1; iouter <= na; iouter++) {
    int cnt = 0;
    while (cnt < nonzer) {
      x = (x * NPB_A) & MASK46;
      double vecelt = (double)x * 0x1p-46;
      x = (x * NPB_A) & MASK46;
      long i = (long)(x >> shift_bits) + 1;
      if (i > na) continue;
      int dup = 0;
      for (int k = 0; k < cnt; k++)
        if (row_pos[k] == i) { dup = 1; break; }
      if (dup) continue;
      row_pos[cnt] = i;
      row_val[cnt] = vecelt;
      cnt++;
    }
    /* vecset (cg.f:718): force position iouter with value 0.5 */
    int found = -1;
    for (int k = 0; k < cnt; k++)
      if (row_pos[k] == iouter) { found = k; break; }
    if (found >= 0) {
      row_val[found] = 0.5;
    } else {
      row_pos[cnt] = iouter;
      row_val[cnt] = 0.5;
      cnt++;
    }
    nzv[iouter - 1] = cnt;
    for (int k = 0; k < cnt; k++) {
      pos[w] = row_pos[k];
      val[w] = row_val[k];
      w++;
    }
  }
  free(row_pos);
  free(row_val);
  return w;
}

/* ------------------------------------------------------------------ */
/* Benes network construction (kernels/routenet.py hot loop).          */
/*                                                                     */
/* Given a permutation perm[m] (element i -> position perm[i], m a     */
/* power of two), emit the switch masks of the 2*log2(m)-1 exchange    */
/* stages into masks_out[stage][i] (uint8 0/1), stage order            */
/* in-stages (distance m/2 .. 2), base stage (1), out-stages (2..m/2). */
/* The 2-coloring walks each constraint cycle sequentially (O(m) per   */
/* level) instead of the numpy pointer-jumping (O(m log m) with big    */
/* constants) -- measured ~30x faster at m = 2^21.                     */
/* Switch settings differ from the numpy constructor's (coloring       */
/* freedom) but realize the same permutation.                          */
/* ------------------------------------------------------------------ */

int benes_route_c(int64_t m, const int32_t* perm, uint8_t* masks_out) {
    if (m < 2 || (m & (m - 1)) != 0) return -1;
    int nlev = 0;
    for (int64_t t = m; t > 1; t >>= 1) nlev++;
    int S = 2 * nlev - 1;
    int32_t* cur = (int32_t*)malloc(sizeof(int32_t) * m);
    int32_t* nxt = (int32_t*)malloc(sizeof(int32_t) * m);
    int32_t* inv = (int32_t*)malloc(sizeof(int32_t) * m);
    int8_t* color = (int8_t*)malloc(m);
    int32_t* elem_at = (int32_t*)malloc(sizeof(int32_t) * m);
    if (!cur || !nxt || !inv || !color || !elem_at) return -2;
    for (int64_t i = 0; i < m; i++) cur[i] = perm[i];

    for (int lev = 0; lev < nlev - 1; lev++) {
        int64_t ml = m >> lev;
        int64_t h = ml >> 1;
        uint8_t* min = masks_out + (int64_t)lev * m;
        uint8_t* mout = masks_out + (int64_t)(S - 1 - lev) * m;
        for (int64_t base = 0; base < m; base += ml) {
            int32_t* c = cur + base;
            int32_t* iv = inv + base;
            int8_t* col = color;           /* block-local, reused */
            for (int64_t i = 0; i < ml; i++) iv[c[i]] = (int32_t)i;
            for (int64_t i = 0; i < ml; i++) col[i] = -1;
            /* 2-color the union of matchings in_nbr(e)=e^h,
               out_nbr(e)=iv[(c[e]+h) mod ml] by walking cycles */
            for (int64_t s = 0; s < ml; s++) {
                if (col[s] >= 0) continue;
                int64_t e = s;
                int8_t cc = 0;
                while (col[e] < 0) {
                    col[e] = cc;
                    int64_t p = e ^ h;          /* input partner: opposite */
                    col[p] = (int8_t)(1 - cc);
                    /* output partner of p: opposite of p == cc again */
                    e = iv[(c[p] + h) & (ml - 1)];
                }
            }
            /* input stage: swap pair (i, i+h) iff color of low == 1 */
            for (int64_t i = 0; i < h; i++) {
                uint8_t sw = (uint8_t)(col[i] == 1);
                min[base + i] = sw;
                min[base + i + h] = sw;
            }
            /* output stage: swap at destination pair (j, j+h) iff the
               element destined for low output j has color 1 */
            for (int64_t j = 0; j < h; j++) {
                uint8_t sw = (uint8_t)(col[iv[j]] == 1);
                mout[base + j] = sw;
                mout[base + j + h] = sw;
            }
            /* next level: element i sits at (i mod h) + h*col[i];
               its sub-destination is c[i] mod h */
            for (int64_t i = 0; i < ml; i++)
                elem_at[(i % h) + h * (int64_t)col[i]] = (int32_t)i;
            for (int64_t p = 0; p < ml; p++)
                nxt[base + p] = (int32_t)(c[elem_at[p]] & (h - 1));
        }
        int32_t* tmp = cur; cur = nxt; nxt = tmp;
    }
    /* base level: blocks of 2, one stage at distance 1 */
    uint8_t* mbase = masks_out + (int64_t)(nlev - 1) * m;
    for (int64_t i = 0; i < m; i++)
        mbase[i] = (uint8_t)(cur[i] != (int32_t)(i & 1));
    free(cur); free(nxt); free(inv); free(color); free(elem_at);
    return S;
}

/* --------------- MatrixMarket coordinate fast parser ------------------ */

/* Parses the numeric body of an .mtx coordinate file (after the header and
 * size line). pattern: 2 ints/line; real: 2 ints + 1 double. Returns the
 * number of entries parsed or -1 on error. */
long mm_parse_body(const char* path, long skip_lines, long nnz, int pattern,
                   int64_t* rows, int64_t* cols, double* vals) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  char buf[512];
  for (long i = 0; i < skip_lines; i++)
    if (!fgets(buf, sizeof buf, f)) { fclose(f); return -1; }
  long k = 0;
  if (pattern) {
    long r, c;
    while (k < nnz && fscanf(f, "%ld %ld", &r, &c) == 2) {
      rows[k] = r; cols[k] = c; vals[k] = 1.0; k++;
    }
  } else {
    long r, c; double v;
    while (k < nnz && fscanf(f, "%ld %ld %lf", &r, &c, &v) == 3) {
      rows[k] = r; cols[k] = c; vals[k] = v; k++;
    }
  }
  fclose(f);
  return k;
}
