"""Plain reference for NPB CG: a frozen copy of NPB's ``makea`` and the
power iteration of cg.f, in numpy and plain torch.

Imports nothing of the measured program. It rebuilds the class's matrix
from NPB's random stream, stores it as its factors V (the rows a_i of
cg.f's outer products) and the weights s, and runs the inverse power
iteration in IEEE double:

    A = sum_i s_i a_i a_i^T + (rcond - shift) I            (cg.f:650-905)
    A x = V^T (s * (V x)) + (rcond - shift) x

which is makea's sum of outer products with the sums taken in another
order (O(eps) per entry).

``makea_triples`` is the fast form of NPB's stream consumption;
``makea_triples_loop`` is the plain loop it is held to in the tests.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

_MASK46 = (1 << 46) - 1
AMULT = 1220703125  # 5^13 (cg.f:187)
TRAN0 = 314159265  # cg.f:186


@dataclasses.dataclass(frozen=True)
class NPBClass:
    """One NPB CG class as npbparams / cg.f:122-163 state it."""

    name: str
    na: int
    nonzer: int
    niter: int
    shift: float
    rcond: float
    zeta_verify: float


def _shift_bits(na: int) -> int:
    nn1 = 1
    while nn1 < na:
        nn1 *= 2
    return 46 - (nn1.bit_length() - 1)  # icnvrt's chop to nn1 (cg.f:975-989)


def _start_state() -> int:
    # zeta = randlc(tran, amult) is drawn once before makea (cg.f:188)
    return (TRAN0 * AMULT) & _MASK46


def makea_triples_loop(na: int, nonzer: int):
    """sprnvc / vecset (cg.f:707-720, 911-989) as NPB writes them, one draw
    at a time. Returns (nzv [na], ivc 1-based int64, vc float64)."""
    shift = _shift_bits(na)
    x = _start_state()
    nzv = np.empty(na, dtype=np.int64)
    ivc, vc = [], []
    for row in range(1, na + 1):
        pos, vals = [], []
        while len(pos) < nonzer:
            x = (x * AMULT) & _MASK46
            vecelt = x * 0.5**46
            x = (x * AMULT) & _MASK46
            i = (x >> shift) + 1
            if i > na or i in pos:
                continue
            pos.append(i)
            vals.append(vecelt)
        if row in pos:  # vecset: element `row` becomes 0.5
            vals[pos.index(row)] = 0.5
        else:
            pos.append(row)
            vals.append(0.5)
        nzv[row - 1] = len(pos)
        ivc += pos
        vc += vals
    return nzv, np.asarray(ivc, dtype=np.int64), np.asarray(vc, dtype=np.float64)


def _powers(count: int) -> np.ndarray:
    """AMULT**k mod 2**64 for k = 0 .. count-1 (the low 46 bits of a
    wrapped 64-bit product are exact)."""
    pw = np.ones(1, dtype=np.uint64)
    step = np.uint64(AMULT)
    with np.errstate(over="ignore"):
        while len(pw) < count:
            pw = np.concatenate([pw, pw * step])
            step = step * step
    return pw[:count]


def makea_triples(na: int, nonzer: int, pairs_per_block: int = 1 << 18):
    """The same triples as makea_triples_loop, drawn a block of the stream
    at a time: a block's rows are cut on the assumption that no row draws a
    position twice, and the first row that did is redone draw by draw."""
    shift = np.uint64(_shift_bits(na))
    mask = np.uint64(_MASK46)
    pw = _powers(2 * pairs_per_block + 1)
    x = _start_state()
    rows_pos, rows_val = [], []
    done = 0
    with np.errstate(over="ignore"):
        while done < na:
            states = (np.uint64(x) * pw) & mask  # states[k] = x * a^k
            vecelt = states[1::2].astype(np.float64) * 0.5**46
            pos = (states[2::2] >> shift).astype(np.int64) + 1
            ok = np.flatnonzero(pos <= na)
            # one row's draws are kept spare for a row that is redone
            nrows = min(len(ok) // nonzer - 1, na - done)
            take = ok[: nrows * nonzer].reshape(nrows, nonzer)
            p = pos[take]
            ps = np.sort(p, axis=1)
            dup = np.flatnonzero((ps[:, 1:] == ps[:, :-1]).any(axis=1))
            good = nrows if not len(dup) else int(dup[0])
            rows_pos.append(p[:good])
            rows_val.append(vecelt[take[:good]])
            done += good
            # the pair after the last good row's last draw starts the next
            # part of the stream
            next_pair = int(take[good - 1, -1]) + 1 if good else 0
            if good == nrows:
                x = int(states[2 * next_pair])
                continue
            # redo the row that drew a position twice, draw by draw
            k = next_pair
            seen, vals = [], []
            while len(seen) < nonzer:
                if k == len(pos):
                    raise RuntimeError("makea: a row drew past its block")
                i = int(pos[k])
                if i <= na and i not in seen:
                    seen.append(i)
                    vals.append(float(vecelt[k]))
                k += 1
            rows_pos.append(np.asarray([seen], dtype=np.int64))
            rows_val.append(np.asarray([vals], dtype=np.float64))
            done += 1
            x = int(states[2 * k])
    P = np.concatenate(rows_pos)[:na]
    V = np.concatenate(rows_val)[:na]
    # vecset (cg.f:718): element `row` becomes 0.5, appended when not drawn
    row = np.arange(1, na + 1, dtype=np.int64)
    hit = P == row[:, None]
    V = np.where(hit, 0.5, V)
    has = hit.any(axis=1)
    nzv = np.where(has, nonzer, nonzer + 1).astype(np.int64)
    extra = np.where(has, 0, row)
    P = np.concatenate([P, extra[:, None]], axis=1)
    V = np.concatenate([V, np.where(has, 0.0, 0.5)[:, None]], axis=1)
    keep = np.ones(P.shape, dtype=bool)
    keep[:, -1] = ~has
    return nzv, P[keep], V[keep]


def size_ramp(cls: NPBClass) -> np.ndarray:
    """The outer products' weights: size = size * ratio row by row
    (cg.f:830), a sequential product as in Fortran."""
    ratio = cls.rcond ** (1.0 / cls.na)
    s = np.empty(cls.na, dtype=np.float64)
    s[0] = 1.0
    np.multiply.accumulate(np.full(cls.na - 1, ratio), out=s[1:])
    return s


class Operator:
    """A x = V^T (s * (V x)) + (rcond - shift) x in float64, V and V^T as
    torch CSR matrices on `device`."""

    def __init__(self, cls: NPBClass, triples, device, dtype=torch.float64):
        nzv, ivc, vc = triples
        n = cls.na
        rows = np.repeat(np.arange(n, dtype=np.int64), nzv)
        cols = ivc - 1
        self.n = n
        self.dtype = dtype
        self.V = _csr(rows, cols, vc, n, device, dtype)
        self.VT = _csr(cols, rows, vc, n, device, dtype)
        self.s = torch.as_tensor(size_ramp(cls), device=device).to(dtype)
        self.d0 = float(cls.rcond - cls.shift)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        t = torch.mv(self.V, x)
        return torch.mv(self.VT, self.s * t) + self.d0 * x


def _csr(rows, cols, vals, n, device, dtype):
    """CSR of the triples (no two share a place), sorted on `device`."""
    rows = torch.as_tensor(rows, device=device)
    cols = torch.as_tensor(cols, device=device)
    order = torch.argsort(rows * n + cols)
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.bincount(rows, minlength=n), 0, out=ptr[1:])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "beta state"
        return torch.sparse_csr_tensor(
            ptr, cols[order], torch.as_tensor(vals, device=device)[order].to(dtype),
            (n, n), check_invariants=False)


def conj_grad(op, x, cgitmax: int = 25):
    """cg.f:447-639: 25 CG iterations from z = 0, then ||x - A z||."""
    z = torch.zeros_like(x)
    r = x.clone()
    p = r.clone()
    rho = torch.dot(r, r)
    for _ in range(cgitmax):
        q = op(p)
        alpha = rho / torch.dot(p, q)
        z = z + alpha * p
        r = r - alpha * q
        rho_new = torch.dot(r, r)
        p = r + (rho_new / rho) * p
        rho = rho_new
    d = x - op(z)
    return z, torch.sqrt(torch.dot(d, d))


def power_method(op, x0: torch.Tensor, shift: float, steps: int):
    """cg.f:299-349: `steps` outer steps from x0. Returns the zeta and
    rnorm histories (numpy float64) and the last x."""
    x = x0
    zetas, rnorms = [], []
    for _ in range(steps):
        z, rnorm = conj_grad(op, x)
        zetas.append(shift + 1.0 / torch.dot(x, z))
        rnorms.append(rnorm)
        x = z / torch.sqrt(torch.dot(z, z))
    hist = torch.stack(zetas + rnorms).double().cpu().numpy()
    return hist[:steps], hist[steps:], x


def relabel(ivc: np.ndarray, na: int) -> np.ndarray:
    """sigma: the columns by descending count of entries, ties in index
    order. The measured program's routed operator numbers its vectors so
    (position k holds column sigma[k])."""
    cnt = np.bincount(ivc - 1, minlength=na)
    return np.argsort(-cnt, kind="stable")
