"""SparseBench random-CRS test-matrix generator (exact host-side port).

Faithful reproduction of SparseBench/SRC/reference/
gen_crs.f + random_gen.f so the golden `reference_results` iteration/
residual table can be matched bit-for-bit on matrix structure:

* RNG: LAPACK DLARAN — 48-bit multiplicative LCG, multiplier
  33952834046453, seed (127,0,0,1) => x0 = 127*2^36 + 1
  (random_gen.f:44-101); value = x * 2^-48 (exact in f64).
* make_blocks: recursive unbalanced bisection (gen_crs.f:160-230),
  including the reference's `splits(4,blocks)` direction-index quirk
  (gen_crs.f:203,218 use the block COUNT as an index) — reproduced, since
  the golden matrices embed it.
* fill_matrix: diagonal bmrand()/n, then per-block damped random fill with
  symmetric (i,j)/(j,i) pairs and diagonal |v| accumulation
  (gen_crs.f:240-340,430-460).
* convert to CRS + positive_diagonal kludge (gen_crs.f:638-663).
* Cuthill-McKee permutation, ord=2 (gen_crs.f:545-600 + permute at
  main.f:176-183), with per-row ascending column sort.

The generated system is solved with x0 = 0, b = ones, rtol 1e-6,
maxit 100 (main.f:341-345,366).

Counterpart of lilac_tpu/generate/sparsebench_gen.py: numpy only, the same
arrays bit for bit. The fill loop runs in the port's own C copy
(native/, sb_fill_matrix) where a C compiler is at hand, else in Python;
both consume the same DLARAN stream.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from lilac_tpu_torch import native
from lilac_tpu_torch.formats.convert import coo_to_csr_arrays

_DLARAN_A = 33952834046453  # lapack dlaran multiplier
_MASK48 = (1 << 48) - 1


class DLaran:
    def __init__(self):
        self.x = 127 * (1 << 36) + 1  # iseed (127,0,0,1)

    def next(self) -> float:
        self.x = (self.x * _DLARAN_A) & _MASK48
        return self.x * 0.5**48

    def take(self, n: int) -> np.ndarray:
        """Vectorized batch of the next n values (exact, mod-2^48 in uint64).

        (a*b) mod 2^48 == ((a mod 2^64)*(b mod 2^64)) mod 2^48 since
        2^48 | 2^64, so uint64 wraparound arithmetic is safe. Each 48-bit
        state is exactly representable in f64, so `x * 2**-48` matches the
        reference DLARAN's nested 12-bit evaluation bit-for-bit
        (SparseBench/SRC/reference/random_gen.f:44-101).
        """
        # powers A^1..A^n mod 2^64 by doubling
        pw = np.empty(n, dtype=np.uint64)
        if n == 0:
            return np.empty(0, dtype=np.float64)
        a = np.uint64(_DLARAN_A & ((1 << 64) - 1))
        pw[0] = a
        filled = 1
        with np.errstate(over="ignore"):
            while filled < n:
                m = min(filled, n - filled)
                pw[filled : filled + m] = pw[:m] * pw[filled - 1]
                filled += m
            xs = (np.uint64(self.x) * pw) & np.uint64(_MASK48)
        self.x = int(xs[-1])
        return xs.astype(np.float64) * 0.5**48


def _ceil_ref(x: float) -> int:
    """gen_crs.f's own ceil (exact-integer check then int()+1)."""
    if x == int(x):
        return int(x)
    return int(x) + 1


def make_blocks(n: int, unbalance: float, rng: DLaran, max_levels: int = 500):
    """Recursive bisection; returns splits as a list of [s1, s2, s3, dir]."""
    splits = [[1, int((1 + unbalance * (2 * rng.next() - 1)) * (1 + n) / 2 + 1), n, 1]]
    b_per_level = [1]
    first = 0  # 0-based index of first block of current level
    top = 0  # 0-based index of last block
    for level in range(max_levels):
        blocks = b_per_level[level]
        nxt = 0
        last = first + blocks - 1
        for bi in range(first, last + 1):
            s1, s2, s3, _ = splits[bi]
            if s2 - 1 < s1:
                raise RuntimeError("negative side")
            elif s2 - 1 > s1:
                top += 1
                nxt += 1
                # NOTE reference quirk: direction flips against
                # splits(4, blocks) — the block COUNT used as index
                splits.append([s1, (s1 + s2) // 2, s2 - 1, 3 - splits[blocks - 1][3]])
            if s3 < s2:
                raise RuntimeError("negative side")
            elif s3 > s2:
                top += 1
                nxt += 1
                splits.append([s2, (s2 + s3 + 1) // 2, s3, 3 - splits[blocks - 1][3]])
        b_per_level.append(nxt)
        first = last + 1
        if nxt == 0:
            break
    return splits


def fill_matrix(
    splits, n: int, rng: DLaran, decay=0.1, cutoff=0.8, d=3.0, c=2.0, sym=False
):
    """Returns COO lists (rows, cols, vals) 1-based, diagonal first."""
    diag_val = np.empty(n, dtype=np.float64)
    for i in range(n):
        diag_val[i] = rng.next() / n
    rows, cols, vals = [], [], []

    def fill_elt(block_i, i, j):
        rval = 2 * rng.next() - 1.0
        rows.append(i)
        cols.append(j)
        vals.append(rval)
        if not sym:
            # unsym storage keeps the mirrored entry too (gen_crs.f:448-451;
            # the _symm generator stores one triangle only)
            rows.append(j)
            cols.append(i)
            vals.append(rval)
        if i != j:
            if block_i == 0:
                rval = 1.1 * rval
            diag_val[i - 1] += abs(rval)
            diag_val[j - 1] += abs(rval)

    inv_cut = 1.0 / cutoff
    for bi, (s1, s2, s3, direction) in enumerate(splits):
        i1, i2 = s1, s2 - 1
        j1, j2 = s2, s3
        if i1 == i2 or j1 == j2:
            for i in range(i1, i2 + 1):
                for j in range(j1, j2 + 1):
                    fill_elt(bi, i, j)
            continue
        hinv_i = int(1 + (i2 - i1 + 1.001) ** (1.0 / d))
        allow_i = float(hinv_i) ** (d - 1.0)
        hinv_j = int(1 + (j2 - j1 + 1.001) ** (1.0 / d))
        allow_j = float(hinv_j) ** (d - 1.0)
        bdry = int(min(i2 - i1 + 1 - allow_i, j2 - j1 + 1 - allow_j))
        if direction == 1:
            for i in range(i1, i2 + 1):
                md = _min_i_damp(i, i1, i2, j1, j2, bdry, decay)
                if md > inv_cut:
                    continue
                for j in range(j1, j2 + 1):
                    damp = _reg_damp(direction, i, j, i1, j1, hinv_i, hinv_j, bdry, decay)
                    rval = rng.next()
                    if rval / damp > cutoff:
                        fill_elt(bi, i, j)
        else:
            cl = max(1, (i2 - i1) // hinv_i)
            for ic in range(i1, i2 + 1, cl):
                for jc in range(j1, j2 + 1, cl):
                    md = _min_ij_damp(ic, jc, i1, j1, hinv_i, decay)
                    if md > inv_cut:
                        continue
                    for i in range(ic, min(i2, ic + cl - 1) + 1):
                        for j in range(jc, min(j2, jc + cl - 1) + 1):
                            damp = _reg_damp(
                                direction, i, j, i1, j1, hinv_i, hinv_j, bdry, decay
                            )
                            rval = rng.next()
                            if rval / damp > cutoff:
                                fill_elt(bi, i, j)

    all_rows = np.concatenate([np.arange(1, n + 1), np.asarray(rows, dtype=np.int64)]) if rows else np.arange(1, n + 1)
    all_cols = np.concatenate([np.arange(1, n + 1), np.asarray(cols, dtype=np.int64)]) if cols else np.arange(1, n + 1)
    all_vals = np.concatenate([diag_val, np.asarray(vals, dtype=np.float64)]) if vals else diag_val
    return all_rows, all_cols, all_vals


def _min_i_damp(i, i1, i2, j1, j2, bdry, decay):
    aim = (i - i1) - bdry
    if aim >= 0 and j1 + aim <= j2:
        return 1.0
    if aim < 0:
        return (-aim * 0.5 + 1.0) ** decay
    return ((j1 + aim - j2) * 0.5 + 1.0) ** decay


def _min_ij_damp(ic, jc, i1, j1, hinv_i, decay):
    return (_ceil_ref(abs(ic - i1 - jc + j1) / (1.0 * hinv_i)) + 1.0) ** decay


def _reg_damp(direction, i, j, i1, j1, hinv_i, hinv_j, bdry, decay):
    if direction == 1:
        return (abs((j - j1) - (i - i1) + bdry) * 0.5 + 1.0) ** decay
    il = (i - i1) % hinv_i
    jl = (j - j1) % hinv_i
    return (
        (hinv_i - 1 - il + jl + _ceil_ref(abs(i - i1 - j + j1) / (1.0 * hinv_i)))
        + 1.0
    ) ** decay


def cuthill_mckee(indptr, indices, n: int) -> np.ndarray:
    """compute_ordering ord=2 (gen_crs.f): BFS from node 1 in stored column
    order, restart at lowest unvisited node. Returns ordering (1-based node
    ids in new order)."""
    ordering = np.zeros(n, dtype=np.int64)
    visited = np.zeros(n + 1, dtype=bool)
    ordering[0] = 1
    visited[1] = True
    top = 0  # 0-based index of last ordered
    low = 0
    for _ in range(n):
        if ordering[low] == 0:
            # restart at lowest unvisited
            col = int(np.nonzero(~visited[1:])[0][0]) + 1
            top = low
            ordering[low] = col
            visited[col] = True
        row = ordering[low]
        for k in range(indptr[row - 1], indptr[row]):
            col = indices[k]
            if visited[col]:
                continue
            top += 1
            ordering[top] = col
            visited[col] = True
            if top == n - 1:
                return ordering
        low += 1
        if low >= n:
            break
    return ordering


def generate_crs(
    side: int, sym: bool = False
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    """Full struct=2 matrix pipeline for a given `side` (n = side^3).

    Returns 0-based canonical CSR (indptr, indices, data) after the
    Cuthill-McKee permutation, exactly as the solver sees it
    (main.f:131-196). With sym=True this is gen_crs_symm.f: one-triangle
    storage, same RNG stream (the only diff is the mirrored-entry append).
    """
    n = side**3
    unbalance = 0.3
    rng = DLaran()
    splits = make_blocks(n, unbalance, rng)
    rng = DLaran()  # generate_crs_matrix calls init_rand again (gen_crs.f:62)
    if native.available():  # C fast path (native/): exact same DLARAN stream
        r, c, v, diag, state = native.sb_fill_matrix(
            np.asarray(splits, dtype=np.int64), n, sym, rng.x
        )
        rng.x = state
        rows = np.concatenate([np.arange(1, n + 1), r])
        cols = np.concatenate([np.arange(1, n + 1), c])
        vals = np.concatenate([diag, v])
    else:
        rows, cols, vals = fill_matrix(splits, n, rng, sym=sym)

    # assemble CRS (no duplicates by construction), columns sorted per row
    indptr, indices, data = coo_to_csr_arrays(
        rows - 1, cols - 1, vals, (n, n), sum_duplicates=False
    )
    # positive_diagonal kludge: zero diagonals get a fresh random value
    for i in range(n):
        for k in range(indptr[i], indptr[i + 1]):
            if indices[k] == i and data[k] == 0.0:
                data[k] = rng.next()

    # Cuthill-McKee permutation (ord=2) on 1-based structure
    ordering = cuthill_mckee(indptr, indices + 1, n)
    inv = np.zeros(n + 1, dtype=np.int64)
    inv[ordering] = np.arange(1, n + 1)

    # permute rows by `ordering`, map columns through inv, sort rows
    counts = np.diff(indptr)
    new_counts = counts[ordering - 1]
    new_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(new_counts, out=new_indptr[1:])
    new_indices = np.empty_like(indices)
    new_data = np.empty_like(data)
    for irow in range(n):
        row = ordering[irow] - 1
        lo, hi = indptr[row], indptr[row + 1]
        seg_cols = inv[indices[lo:hi] + 1] - 1
        seg_vals = data[lo:hi]
        order = np.argsort(seg_cols, kind="stable")
        dst = slice(new_indptr[irow], new_indptr[irow + 1])
        new_indices[dst] = seg_cols[order]
        new_data[dst] = seg_vals[order]
    return new_indptr.astype(np.int32), new_indices.astype(np.int32), new_data, (n, n)


# ---------------------------------------------------------------------------
# Regular 7-point structure (SparseBench structure=1), exact ports
# ---------------------------------------------------------------------------


def seven_point_bands_symm(side: int):
    """gen_reg_symm.f:6-78 — symmetric band storage a[n1,0:3,n2,n3].

    Returns bands as a dict {0: diag, 1: +x, 2: +y, 3: +z}, each an
    f64 array indexed [i1, i2, i3] (0-based), n1=n2=n3=side. Band p>0 at
    site s couples s -> s+e_p; symmetric counterpart implied.

    The reference's p<0 diagonal-scatter loop writes a(i1+o1,0,i2+o2,i3+o3)
    without a HIGH-face guard (its `no` checks the LOW face,
    gen_reg_symm.f:52-58), so high-boundary sites write out of row range:
    in Fortran column-major layout a(n1+1,0,i2,i3) aliases a(1,1,i2,i3)
    (the +x band) and a(i1,0,n2+1,i3) aliases a(i1,0,1,i3+1). The golden
    matrices embed those aliased sums, so this port simulates the exact
    arena writes rather than the intended stencil.
    """
    n1 = n2 = n3 = side
    rng = DLaran()  # init_rand (random_gen.f:103-111)
    # cof(n1+1, n2+1, n3+1, 3), loop order p, i1, i2, i3 (innermost i3)
    vals = rng.take(3 * (n1 + 1) * (n2 + 1) * (n3 + 1))
    cof = vals.reshape(3, n1 + 1, n2 + 1, n3 + 1)  # [p-1, i1-1, i2-1, i3-1]

    # linear arena for a(n1,0:3,n2,n3) + slack for writes past the array
    # (those landed in not-yet-allocated arena space, harmless to the run)
    size = 4 * n1 * n2 * n3
    arena = np.zeros(size + 8 * n1 * n2, dtype=np.float64)

    i1g, i2g, i3g = np.meshgrid(
        np.arange(1, n1 + 1), np.arange(1, n2 + 1), np.arange(1, n3 + 1),
        indexing="ij",
    )

    def addr(i1, b, i2, i3):
        return (i1 - 1) + n1 * b + 4 * n1 * (i2 - 1) + 4 * n1 * n2 * (i3 - 1)

    offs = {1: (1, 0, 0), 2: (0, 1, 0), 3: (0, 0, 1)}
    for p in (-3, -2, -1, 1, 2, 3):
        o1, o2, o3 = offs[abs(p)]
        if p > 0:
            c = cof[p - 1, o1 : n1 + o1, o2 : n2 + o2, o3 : n3 + o3]
            hi_face = (i1g == n1, i2g == n2, i3g == n3)[p - 1]
            band_addr = addr(i1g, p, i2g, i3g)
            # ASSIGNMENT (gen_reg_symm.f:64): overwrites any aliased p<0
            # contribution that landed in this band earlier
            arena[band_addr[~hi_face]] = -c[~hi_face]
            np.add.at(arena, addr(i1g, 0, i2g, i3g).ravel(), c.ravel())
        else:
            c = cof[-p - 1, :n1, :n2, :n3]
            lo_face = (i1g == 1, i2g == 1, i3g == 1)[-p - 1]
            tgt = addr(i1g + o1, 0, i2g + o2, i3g + o3)
            sel = ~lo_face & (tgt < len(arena))
            np.add.at(arena, tgt[sel], c[sel])

    a_view = arena[:size].reshape(n3, n2, 4, n1)  # reverse of column-major
    bands = {}
    for b in range(4):
        bands[b] = np.ascontiguousarray(a_view[:, :, b, :].transpose(2, 1, 0))
    return bands


def seven_point_bands_unsym(side: int, u: float = 0.1):
    """gen_reg.f:6-77 — unsymmetric bands a[n1,-3:3,n2,n3] (u=.1, main.f:111).

    Returns dict {-3..3: band}, band[p] at site s is the coefficient of
    x[s+e_p] in row s (off-diagonals already negated, boundaries zeroed).
    """
    n1 = n2 = n3 = side
    rng = DLaran()
    raw = rng.take(2 * 3 * n1 * n2 * n3).reshape(3, n1, n2, n3, 2)
    r1 = raw[..., 0]
    r2 = raw[..., 1] * u
    offs = {1: (1, 0, 0), 2: (0, 1, 0), 3: (0, 0, 1)}
    cof = {}
    for p in (1, 2, 3):
        o1, o2, o3 = offs[p]
        cof[p] = r1[p - 1] * (1.0 + r2[p - 1])
        cm = np.zeros((n1, n2, n3))
        low = r1[p - 1] * (1.0 - r2[p - 1])
        # cof(i+o, -p) = low(i) for sites with i+o in range
        if p == 1:
            cm[1:, :, :] = low[: n1 - 1, :, :]
        elif p == 2:
            cm[:, 1:, :] = low[:, : n2 - 1, :]
        else:
            cm[:, :, 1:] = low[:, :, : n3 - 1]
        cof[-p] = cm

    bands = {0: np.zeros((n1, n2, n3))}
    for p in (-3, -2, -1, 1, 2, 3):
        c = cof[p]
        band = -c.copy()
        # zero the boundary face where the neighbour falls outside
        if p == 1:
            band[n1 - 1, :, :] = 0.0
        elif p == -1:
            band[0, :, :] = 0.0
        elif p == 2:
            band[:, n2 - 1, :] = 0.0
        elif p == -2:
            band[:, 0, :] = 0.0
        elif p == 3:
            band[:, :, n3 - 1] = 0.0
        else:
            band[:, :, 0] = 0.0
        bands[p] = band
        bands[0] += c  # diag += c at every site, both signs (regular.f:58-71)
    return bands


def bands_to_csr(bands, side: int):
    """Band dict -> canonical 0-based CSR of the full operator.

    Site linear index row = (i1-1) + n1*(i2-1) + n1*n2*(i3-1) — Fortran
    column-major vector layout x(i1,i2,i3) (regular.f:17).
    """
    n1 = n2 = n3 = side
    n = n1 * n2 * n3
    i1, i2, i3 = np.meshgrid(
        np.arange(n1), np.arange(n2), np.arange(n3), indexing="ij"
    )
    row = (i1 + n1 * i2 + n1 * n2 * i3).ravel()
    step = {1: 1, 2: n1, 3: n1 * n2, -1: -1, -2: -n1, -3: -n1 * n2}
    rows, cols, vals = [row], [row], [bands[0].ravel()]
    for p, band in bands.items():
        if p == 0:
            continue
        b = band.ravel()
        nz = b != 0.0
        # a symmetric-storage band implies the mirrored coefficient too
        rows.append(row[nz])
        cols.append(row[nz] + step[p])
        vals.append(b[nz])
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    v = np.concatenate(vals)
    indptr, indices, data = coo_to_csr_arrays(r, c, v, (n, n), sum_duplicates=False)
    return indptr, indices, data, (n, n)


def regular_system(side: int, sym: bool):
    """Full effective operator + preconditioner parts for structure=1.

    Returns dict with 'A' = (indptr, indices, data, shape) of the effective
    operator and band dicts for preconditioner construction:
      'L', 'U'   : strict lower/upper band dicts (natural site order)
      'diag'     : diagonal vector
    For sym storage the lower bands are the transposed upper coefficients
    (regular_symm.f:121-311 reads a(i1-1,1,..) etc. as L).
    """
    if sym:
        up = seven_point_bands_symm(side)
        bands = dict(up)
        # materialize explicit lower bands from the symmetric uppers:
        # L band -p at site s+e_p equals band p at site s.
        for p in (1, 2, 3):
            b = up[p]
            lm = np.zeros_like(b)
            if p == 1:
                lm[1:, :, :] = b[:-1, :, :]
            elif p == 2:
                lm[:, 1:, :] = b[:, :-1, :]
            else:
                lm[:, :, 1:] = b[:, :, :-1]
            bands[-p] = lm
    else:
        bands = seven_point_bands_unsym(side)
    A = bands_to_csr(bands, side)
    # row = i1 + n1*i2 + n1*n2*i3 (i1 fastest) -> Fortran-order ravel
    diag = bands[0].transpose(2, 1, 0).ravel()
    L = {p: bands[p] for p in (-1, -2, -3)}
    U = {p: bands[p] for p in (1, 2, 3)}
    return dict(A=A, bands=bands, diag=diag, L=L, U=U, side=side)


# ---------------------------------------------------------------------------
# Effective operator + preconditioner parts (what the solver actually sees)
# ---------------------------------------------------------------------------


def _strict_parts(indptr, indices, data, n):
    """Split stored CSR into (diag d, before-diag part, after-diag part).

    Requires a stored diagonal in every row (guaranteed by the generators'
    positive_diagonal kludge / diag-first fill). Parts are returned as CSRs
    over the same row space.
    """
    d = np.zeros(n, dtype=np.float64)
    have = np.zeros(n, dtype=bool)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    isdiag = indices == rows
    d[rows[isdiag]] = data[isdiag]
    have[rows[isdiag]] = True
    if not have.all():
        raise ValueError("matrix has rows without a stored diagonal")

    # crs_find_diagonal semantics (mataux.f): dia = position of the diagonal;
    # 'before' = ptr(row)..dia-1, 'after' = dia+1..ptr(row+1)-1 in storage
    # order (columns sorted ascending, so before/after = lower/upper *in the
    # stored index space*).
    def subset(mask):
        sel = np.nonzero(mask)[0]
        sub_indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(sub_indptr, rows[sel] + 1, 1)
        np.cumsum(sub_indptr, out=sub_indptr)
        return sub_indptr.astype(np.int32), indices[sel], data[sel]

    before = subset(indices < rows)
    after = subset(indices > rows)
    return d, before, after


def _csr_transpose(indptr, indices, data, n):
    rows = np.repeat(np.arange(n), np.diff(indptr))
    return coo_to_csr_arrays(indices, rows, data, (n, n), sum_duplicates=False)


def crs_system(side: int, sym: bool):
    """Effective operator + ILU-D parts for structure=2 (random CRS).

    unsym: A = stored matrix; M = (D+L) D^-1 (D+U), L/U = stored strict
    lower/upper (random.f:148-190).
    sym: stored S is one triangle; the matvec computes
    A = S + (S minus first-entry-per-row)^T (random_symm.f:18-48), and the
    ILU-D solve uses T = after-diagonal part as U with L = T^T
    (random_symm.f:113-158). Both reproduced exactly.
    """
    indptr, indices, data, shape = generate_crs(side, sym=sym)
    n = shape[0]
    d, (l_ip, l_ix, l_v), (u_ip, u_ix, u_v) = _strict_parts(
        indptr, indices, data, n
    )
    if sym:
        rows = np.repeat(np.arange(n), np.diff(indptr))
        # skip the first stored entry of each row in the transpose part
        # (random_symm.f:39-44 starts the column loop at ptr(row)+1)
        first = indptr[:-1][np.diff(indptr) > 0]
        keep = np.ones(len(indices), dtype=bool)
        keep[first] = False
        ar = np.concatenate([rows, indices[keep]])
        ac = np.concatenate([indices, rows[keep]])
        av = np.concatenate([data, data[keep]])
        A = coo_to_csr_arrays(ar, ac, av, (n, n), sum_duplicates=True)
        L = _csr_transpose(u_ip, u_ix, u_v, n)
    else:
        A = (indptr, indices, data)
        L = (l_ip, l_ix, l_v)
    return dict(
        A=(A[0], A[1], A[2], (n, n)),
        diag=d,
        L=L,
        U=(u_ip, u_ix, u_v),
        stored=(indptr, indices, data),
    )


def bands_subset_csr(bands, side: int, which):
    """CSR of selected bands only (e.g. strict lower = (-1,-2,-3))."""
    sub = {p: bands[p] for p in which}
    sub[0] = np.zeros_like(bands[0])
    indptr, indices, data, _ = bands_to_csr(sub, side)
    # drop explicit zeros (diag) — keep strict part only
    rows = np.repeat(np.arange(side**3), np.diff(indptr))
    keep = data != 0.0
    return coo_to_csr_arrays(
        rows[keep], indices[keep], data[keep], (side**3, side**3),
        sum_duplicates=False,
    )


def regular_parts(side: int, sym: bool, bjacobi: bool = False):
    """L/U CSR parts for the regular-structure ILU-D / block-Jacobi solves.

    bjacobi restricts coupling to within each i3-plane (regular.f:568-633,
    regular_symm.f:314-380: only the ±1 and ±2 bands participate).
    """
    s = regular_system(side, sym)
    lw = (-1, -2) if bjacobi else (-1, -2, -3)
    uw = (1, 2) if bjacobi else (1, 2, 3)
    L = bands_subset_csr(s["bands"], side, lw)
    U = bands_subset_csr(s["bands"], side, uw)
    return s, L, U
