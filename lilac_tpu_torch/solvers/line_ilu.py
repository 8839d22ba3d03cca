"""Line-ILU preconditioner (SparseBench precond 4, regular structure).

Counterpart of lilac_tpu/solvers/line_ilu.py.

Reference semantics (SparseBench/SRC/reference/):
  - iter.f:360-369 dispatches prec 4 -> lineblock_ilusolve(_t), structure 1
    (regular 7-point stencil on an n1 x n2 x n3 grid) only.
  - regular.f:699-741 line_ilufact: the "factorization" copies the x-line
    tridiagonal (offsets -1,0,1) into a halfbandwidth-hbw band container
    (hbw=3, main.f:287; bands beyond +-1 stay zero) and then ONLY inverts
    the diagonal ("We do not factor, just use block jacobi/ssor",
    regular.f:732-739).
  - regular.f:816-883 lineblock_ilusolve: a block symmetric Gauss-Seidel
    sweep over x-lines. Forward, lines in (i2,i3) lexicographic order:
        rhs  = x - a[-2]*y(line i2-1) - a[-3]*y(line i3-1)
        y    = bandsolve(rhs)            (regular.f:958-989)
    Backward, reverse order:
        tmp  = a[+2]*y(line i2+1) + a[+3]*y(line i3+1)
        y   -= bandsolve(tmp)
    where bandsolve applies the line solve y = (I + D^-1 U)^-1 (D+L)^-1 x
    with L/U the sub/super diagonal of the line tridiagonal and D^-1 the
    stored inverted diagonal, i.e. each line is solved with
    M_line = (D+L) D^-1 (D+U) (scalar SSOR on the line).
  - regular.f:885-953 lineblock_ilusolve_t is a verbatim copy of the
    forward routine; apply_t here is the TRUE transpose solve M^-T x, built
    from shifted band arrays (same engine, L/U roles swapped).

Design (the JAX package's, carried over):
  - The block sweep's dependency graph is a 2-D wavefront over (i2,i3):
    line (i2,i3) depends on (i2-1,i3) and (i2,i3-1), so all lines on an
    anti-diagonal d = i2+i3 are independent. The sweep runs over the
    n2+n3-1 diagonals (a Python loop of eager torch ops here, `lax.scan`
    there) with the diagonal's lines batched (padded to min(n2,n3)).
  - Each batched line solve is two first-order affine recurrences
    y_i = A_i y_{i-1} + B_i, evaluated in O(log n1) depth. The JAX package
    uses `lax.associative_scan`; here `_affine_scan` is a doubling scan
    (log2(n1) rounds of one composition each). The two trees round in
    different places, so the two packages agree to a stated tolerance, not
    bit for bit. Nothing is read back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# batched tridiagonal SSOR line solve via doubling affine scans
# ---------------------------------------------------------------------------


def _affine_scan(A, B, reverse=False):
    """y_i = A_i y_{i-1} + B_i along the last axis (y_{-1} = 0); with
    reverse, y_i = A_i y_{i+1} + B_i (y_{n} = 0).

    Composition of affine maps f_i(v) = A_i v + B_i; the prefix composition
    up to i applied to 0 is exactly y_i. Round r composes each element with
    the one 2^r before it: (a, b) <- (a * a', a * b' + b).
    """
    if reverse:
        A, B = A.flip(-1), B.flip(-1)
    a, b = A, B
    n = A.shape[-1]
    d = 1
    while d < n:
        a_new = a.clone()
        b_new = b.clone()
        a_new[..., d:] = a[..., d:] * a[..., :-d]
        b_new[..., d:] = a[..., d:] * b[..., :-d] + b[..., d:]
        a, b = a_new, b_new
        d *= 2
    return b.flip(-1) if reverse else b


def line_ssor_solve(dinv, am1, ap1, rhs):
    """Batched x-line solve y = (I + D^-1 U)^-1 (D+L)^-1 rhs.

    dinv/am1/ap1/rhs: [..., n1]; am1[..., 0] and ap1[..., -1] must be 0.
    Matches regular.f bandsolve (958-989) with the tridiagonal band.
    """
    # forward: y1_i = -dinv_i*am1_i * y1_{i-1} + dinv_i*rhs_i
    y1 = _affine_scan(-dinv * am1, dinv * rhs)
    # backward: y_i = -dinv_i*ap1_i * y_{i+1} + y1_i
    return _affine_scan(-dinv * ap1, y1, reverse=True)


# ---------------------------------------------------------------------------
# host-built wavefront schedule
# ---------------------------------------------------------------------------


def _wavefront(n2: int, n3: int):
    """Anti-diagonal schedule over lines l = i3*n2 + i2.

    Returns (lines, prev2, prev3, next2, next3): int64 [ndiag, W] with the
    scratch line index (n2*n3) as pad/missing-neighbour sentinel.
    """
    nl = n2 * n3
    pad = nl
    ndiag = n2 + n3 - 1
    W = min(n2, n3)
    lines = np.full((ndiag, W), pad, dtype=np.int64)
    prev2 = np.full((ndiag, W), pad, dtype=np.int64)
    prev3 = np.full((ndiag, W), pad, dtype=np.int64)
    next2 = np.full((ndiag, W), pad, dtype=np.int64)
    next3 = np.full((ndiag, W), pad, dtype=np.int64)
    for d in range(ndiag):
        k = 0
        for i3 in range(max(0, d - n2 + 1), min(d, n3 - 1) + 1):
            i2 = d - i3
            l = i3 * n2 + i2
            lines[d, k] = l
            if i2 > 0:
                prev2[d, k] = l - 1
            if i3 > 0:
                prev3[d, k] = l - n2
            if i2 < n2 - 1:
                next2[d, k] = l + 1
            if i3 < n3 - 1:
                next3[d, k] = l + n2
            k += 1
    return lines, prev2, prev3, next2, next3


# ---------------------------------------------------------------------------
# the preconditioner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LineILU:
    """Line-ILU apply on the device. Build from the generator's band dict
    (generate/sparsebench_gen.py regular_system()['bands'], arrays
    [n1, n2, n3] indexed [i1, i2, i3], row = i1 + n1*i2 + n1*n2*i3).
    """

    n1: int
    n2: int
    n3: int
    # flattened line-major coefficient planes [n2*n3 + 1, n1] (zero pad line)
    dinv: torch.Tensor
    am1: torch.Tensor
    ap1: torch.Tensor
    am2: torch.Tensor
    ap2: torch.Tensor
    am3: torch.Tensor
    ap3: torch.Tensor
    # wavefront schedule [ndiag, W]
    lines: torch.Tensor
    prev2: torch.Tensor
    prev3: torch.Tensor
    next2: torch.Tensor
    next3: torch.Tensor

    @staticmethod
    def build(bands: Dict[int, np.ndarray], transpose: bool = False,
              device="cuda") -> "LineILU":
        """bands[p] for p in -3..3, each [n1, n2, n3].

        transpose=True builds the operator for M^T: every band array is
        replaced by the corresponding shifted opposite band
        ((M^T)_{s,s-e_p} = M_{s-e_p,s}), diagonal unchanged.
        """
        n1, n2, n3 = bands[0].shape
        if transpose:
            bands = _transpose_bands(bands)
        dev = torch.device(device)

        def lines_of(a):
            # [n1,n2,n3] -> line-major [n2*n3, n1] + zero pad line
            a = np.ascontiguousarray(a.transpose(2, 1, 0)).reshape(n3 * n2, n1)
            return torch.as_tensor(
                np.concatenate([a, np.zeros((1, n1))], axis=0), device=dev)

        d = bands[0]
        if np.any(d == 0.0):
            raise ValueError("zero diagonal; line-ILU undefined")
        wf = _wavefront(n2, n3)
        return LineILU(
            n1=n1,
            n2=n2,
            n3=n3,
            dinv=lines_of(1.0 / d),
            am1=lines_of(bands[-1]),
            ap1=lines_of(bands[1]),
            am2=lines_of(bands[-2]),
            ap2=lines_of(bands[2]),
            am3=lines_of(bands[-3]),
            ap3=lines_of(bands[3]),
            lines=torch.as_tensor(wf[0], device=dev),
            prev2=torch.as_tensor(wf[1], device=dev),
            prev3=torch.as_tensor(wf[2], device=dev),
            next2=torch.as_tensor(wf[3], device=dev),
            next3=torch.as_tensor(wf[4], device=dev),
        )

    # -- apply ----------------------------------------------------------------

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """y = M^-1 x for the flattened grid vector x [n1*n2*n3]."""
        nl = self.n2 * self.n3
        xl = torch.cat([x.reshape(nl, self.n1), x.new_zeros((1, self.n1))])
        y = torch.zeros_like(xl)
        # pad entries of a diagonal all write the scratch line nl, which is
        # zeroed again before the next diagonal reads it
        for d in range(self.lines.shape[0]):
            ln, p2, p3 = self.lines[d], self.prev2[d], self.prev3[d]
            rhs = xl[ln] - self.am2[ln] * y[p2] - self.am3[ln] * y[p3]
            y[ln] = line_ssor_solve(self.dinv[ln], self.am1[ln], self.ap1[ln], rhs)
            y[nl] = 0.0
        for d in range(self.lines.shape[0] - 1, -1, -1):
            ln, x2, x3 = self.lines[d], self.next2[d], self.next3[d]
            tmp = self.ap2[ln] * y[x2] + self.ap3[ln] * y[x3]
            tmp = line_ssor_solve(self.dinv[ln], self.am1[ln], self.ap1[ln], tmp)
            y[ln] = y[ln] - tmp
            y[nl] = 0.0
        return y[:nl].reshape(-1)


def _transpose_bands(bands: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
    """Band arrays of M^T: (M^T)_{s, s-e_p} = M_{s-e_p, s} = band[+p] at
    site s-e_p, i.e. the opposite band shifted one step along its axis."""
    axis_of = {1: 0, 2: 1, 3: 2}
    out = {0: bands[0]}
    for p in (1, 2, 3):
        ax = axis_of[p]
        fwd = bands[p]
        back = bands[-p]
        # new -p band at site s = old +p band at s - e_p (shift up along ax)
        m = np.zeros_like(fwd)
        sl_dst = [slice(None)] * 3
        sl_src = [slice(None)] * 3
        sl_dst[ax] = slice(1, None)
        sl_src[ax] = slice(None, -1)
        m[tuple(sl_dst)] = fwd[tuple(sl_src)]
        out[-p] = m
        # new +p band at site s = old -p band at s + e_p (shift down)
        pl = np.zeros_like(back)
        sl_dst2 = [slice(None)] * 3
        sl_src2 = [slice(None)] * 3
        sl_dst2[ax] = slice(None, -1)
        sl_src2[ax] = slice(1, None)
        pl[tuple(sl_dst2)] = back[tuple(sl_src2)]
        out[p] = pl
    return out


def make_line_ilu(bands: Dict[int, np.ndarray], device="cuda") -> Tuple:
    """(psolve, psolve_t) closures for the solvers."""
    M = LineILU.build(bands, device=device)
    Mt = LineILU.build(bands, transpose=True, device=device)
    return M.apply, Mt.apply


# ---------------------------------------------------------------------------
# reference-semantics numpy oracle (for tests; direct loop port of the
# intended math in regular.f:816-989, debug prints and the _t copy-paste
# quirk excluded)
# ---------------------------------------------------------------------------


def reference_line_ilusolve(bands: Dict[int, np.ndarray], x: np.ndarray):
    n1, n2, n3 = bands[0].shape
    dinv = 1.0 / bands[0]
    am1, ap1 = bands[-1], bands[1]
    am2, ap2 = bands[-2], bands[2]
    am3, ap3 = bands[-3], bands[3]
    X = x.reshape(n3, n2, n1)  # [i3, i2, i1]

    def bandsolve(i2, i3, rhs):
        yl = np.zeros(n1)
        for i in range(n1):
            s = am1[i, i2, i3] * yl[i - 1] if i > 0 else 0.0
            yl[i] = dinv[i, i2, i3] * (rhs[i] - s)
        for i in range(n1 - 2, -1, -1):
            yl[i] -= dinv[i, i2, i3] * ap1[i, i2, i3] * yl[i + 1]
        return yl

    Y = np.zeros_like(X)
    for i3 in range(n3):
        for i2 in range(n2):
            rhs = X[i3, i2].copy()
            if i2 > 0:
                rhs -= am2[:, i2, i3] * Y[i3, i2 - 1]
            if i3 > 0:
                rhs -= am3[:, i2, i3] * Y[i3 - 1, i2]
            Y[i3, i2] = bandsolve(i2, i3, rhs)
    for i3 in range(n3 - 1, -1, -1):
        for i2 in range(n2 - 1, -1, -1):
            tmp = np.zeros(n1)
            if i2 < n2 - 1:
                tmp += ap2[:, i2, i3] * Y[i3, i2 + 1]
            if i3 < n3 - 1:
                tmp += ap3[:, i2, i3] * Y[i3 + 1, i2]
            Y[i3, i2] -= bandsolve(i2, i3, tmp)
    return Y.reshape(-1)
