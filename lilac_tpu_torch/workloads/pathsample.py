"""PATHSAMPLE committor (pfold) workload: kinetic analysis of an energy
landscape's Markov chain (wales/PATHSAMPLE).

Counterpart of lilac_tpu/workloads/pathsample.py, on the path of the
reference's Pfold.f90:20-232:

1. read the stationary-point database (min.data / ts.data / min.A / min.B,
   setup.f:1241-1427) and the `pathdata` keyword file;
2. harmonic-TST log rate constants per transition state
   (setup.f:1334-1345, canonical ensemble):
   k± = log(h_min± / (2π h_ts)) + (fvib_min± − fvib_ts)/2 − (E_ts − E_min±)/T
3. connectivity census with NCONNMIN pruning (Pfold.f90:38-66) and dead-TS
   filtering (checkTS.f90);
4. MAKED2 branching-probability matrix with A (direction AB) or B (BA)
   minima as sinks, multi-TS pairs summed and capped at 1
   (Pfold.f90:641-743);
5. BFS from the sink set; minima in disjoint graph components dropped
   (Pfold.f90:115-180);
6. NPFOLD Jacobi committor sweeps q ← D·q with sink rows held fixed: the
   reference's own SPMV skips empty rows (spmv.f90:14-21), which pins the
   sinks at their initial values. The harnessed call at Pfold.f90:221
   passes matrix and vector swapped (SURVEY §3.5); this is the intended
   mathematics.

Steps 1-5, the graph transformation of `ngt` and the rate sums are host
numpy and Python, the JAX package's bit for bit. The sweeps of `pfold` and
`tfold` run on the plan's device as a Python loop over torch ops through
SpmvPlan (f64, a gather kernel: such a plan is declared for one use) and
read nothing back until the last sweep: the host then reads the vector
once, and `pfold` one more product for its residual. The LJ38
min.data / ts.data files are not in the reference's checkout, so the
tests and the bench run on a synthetic landscape, held to the dense
committor solution (the sweep's fixed point).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from lilac_tpu_torch.formats.convert import coo_to_csr_arrays
from lilac_tpu_torch.plan import SpmvPlan


@dataclasses.dataclass
class MinDatabase:
    emin: np.ndarray  # [nmin] energies
    fvib: np.ndarray  # [nmin] log product of vibrational frequencies
    horder: np.ndarray  # [nmin] point-group orders
    ets: np.ndarray  # [nts]
    fvibts: np.ndarray
    hordts: np.ndarray
    plus: np.ndarray  # [nts] 0-based minimum indices
    minus: np.ndarray
    a_set: np.ndarray  # 0-based indices of A minima
    b_set: np.ndarray

    @property
    def nmin(self) -> int:
        return len(self.emin)

    @property
    def nts(self) -> int:
        return len(self.ets)


# ---------------------------------------------------------------------------
# file formats (setup.f:1241-1307; min.A/min.B per setup.f:1199-1233)
# ---------------------------------------------------------------------------


def read_min_data(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """min.data rows: energy, fvib, horder, itx, ity, itz."""
    raw = np.loadtxt(path, usecols=(0, 1, 2), ndmin=2)
    return raw[:, 0], raw[:, 1], raw[:, 2].astype(np.int64)


def read_ts_data(path: str):
    """ts.data rows: energy, fvib, horder, plus, minus, itx, ity, itz."""
    raw = np.loadtxt(path, usecols=(0, 1, 2, 3, 4), ndmin=2)
    return (
        raw[:, 0],
        raw[:, 1],
        raw[:, 2].astype(np.int64),
        raw[:, 3].astype(np.int64) - 1,
        raw[:, 4].astype(np.int64) - 1,
    )


def read_min_set(path: str) -> np.ndarray:
    """min.A / min.B: first line = count, then 1-based indices."""
    toks = open(path).read().split()
    n = int(toks[0])
    return np.asarray([int(t) for t in toks[1 : 1 + n]], dtype=np.int64) - 1


def read_pathdata(path: str) -> dict:
    """Keyword file (pathdata); returns the keys the pfold path consumes."""
    cfg = dict(nconnmin=0, temperature=1.0, direction="AB", npfold=0, omega=1.0)
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("!"):
            continue
        toks = line.split()
        key = toks[0].upper()
        if key == "NCONNMIN":
            cfg["nconnmin"] = int(toks[1])
        elif key == "TEMPERATURE":
            cfg["temperature"] = float(toks[1].replace("D", "E").replace("d", "e"))
        elif key == "DIRECTION":
            cfg["direction"] = toks[1].upper()
        elif key == "PFOLD":
            cfg["npfold"] = int(toks[1])
            if len(toks) > 3:
                cfg["omega"] = float(toks[3])
    return cfg


def load_database(dirpath: str) -> MinDatabase:
    import os

    emin, fvib, horder = read_min_data(os.path.join(dirpath, "min.data"))
    ets, fvibts, hts, plus, minus = read_ts_data(os.path.join(dirpath, "ts.data"))
    return MinDatabase(
        emin, fvib, horder, ets, fvibts, hts, plus, minus,
        read_min_set(os.path.join(dirpath, "min.A")),
        read_min_set(os.path.join(dirpath, "min.B")),
    )


# ---------------------------------------------------------------------------
# rates + branching matrix
# ---------------------------------------------------------------------------


def log_rates(db: MinDatabase, temperature: float):
    """Canonical-ensemble harmonic TST log rates (setup.f:1334-1345)."""
    two_pi = 2.0 * np.pi
    kplus = (
        np.log(db.horder[db.plus] / (two_pi * db.hordts))
        + (db.fvib[db.plus] - db.fvibts) / 2.0
        - (db.ets - db.emin[db.plus]) / temperature
    )
    kminus = (
        np.log(db.horder[db.minus] / (two_pi * db.hordts))
        + (db.fvib[db.minus] - db.fvibts) / 2.0
        - (db.ets - db.emin[db.minus]) / temperature
    )
    deg = db.plus == db.minus
    kplus = np.where(deg, kplus + np.log(2.0), kplus)
    kminus = np.where(deg, kminus + np.log(2.0), kminus)
    return kplus, kminus


def connectivity_census(db: MinDatabase, nconnmin: int):
    """Iterated LNCONN pruning (Pfold.f90:38-66). Returns LNCONN and the
    'connected' mask after fixpoint."""
    connected = np.ones(db.nmin, dtype=bool)
    nondegenerate = db.plus != db.minus
    while True:
        lnconn = np.zeros(db.nmin, dtype=np.int64)
        live = nondegenerate  # CHECKTS with huge nconn: only degenerate dies
        np.add.at(lnconn, db.plus[live], connected[db.minus[live]].astype(np.int64))
        np.add.at(lnconn, db.minus[live], connected[db.plus[live]].astype(np.int64))
        new_connected = lnconn > nconnmin
        if (new_connected == connected).all():
            return lnconn, connected
        connected = new_connected


def branching_matrix(
    db: MinDatabase,
    *,
    temperature: float,
    direction: str = "AB",
    nconnmin: int = 0,
    block_opposite: bool = True,
):
    """MAKED2 (Pfold.f90:641-743) + BFS pruning. Returns (indptr, indices,
    data, has_row) — canonical 0-based CSR of the branching probabilities
    D[m, j] = P(m -> j), with empty rows for sinks/pruned minima."""
    n = db.nmin
    kplus, kminus = log_rates(db, temperature)
    lnconn, _ = connectivity_census(db, nconnmin)
    # deadts (checkTS.f90 with default thresholds): degenerate or
    # under-connected endpoints
    dead = (db.plus == db.minus) | (lnconn[db.plus] <= nconnmin) | (
        lnconn[db.minus] <= nconnmin
    )
    live = ~dead

    lksum = np.zeros(n)
    np.add.at(lksum, db.plus[live], np.exp(kplus[live]))
    np.add.at(lksum, db.minus[live], np.exp(kminus[live]))
    with np.errstate(divide="ignore"):
        lksum = np.where(lksum > 0, np.log(lksum), 0.0)

    is_a = np.zeros(n, dtype=bool)
    is_a[db.a_set] = True
    is_b = np.zeros(n, dtype=bool)
    is_b[db.b_set] = True
    sink = is_a if direction == "AB" else is_b
    # pfold drops transitions INTO the opposite set (Pfold.f90:693-698);
    # TFOLD's matrix keeps them (walkers pass through freely)
    blocked = (is_b if direction == "AB" else is_a) if block_opposite else np.zeros(n, bool)

    # branching contributions: from PLUS->MINUS with exp(kplus - lksum[plus])
    # and MINUS->PLUS with exp(kminus - lksum[minus]); rows for sinks and
    # under-connected minima are dropped (Pfold.f90:676-698)
    rows, cols, vals = [], [], []
    for src, dst, k in (
        (db.plus, db.minus, kplus),
        (db.minus, db.plus, kminus),
    ):
        ok = live & (lnconn[src] > nconnmin) & ~sink[src] & ~blocked[dst]
        rows.append(src[ok])
        cols.append(dst[ok])
        vals.append(np.exp(k[ok] - lksum[src[ok]]))
    row = np.concatenate(rows)
    col = np.concatenate(cols)
    val = np.concatenate(vals)

    indptr, indices, data = coo_to_csr_arrays(row, col, val, (n, n))
    # multi-TS pairs were summed by coo_to_csr_arrays; apply the cap
    # (min(sum,1) == the reference's running cap for positive terms)
    data = np.minimum(data, 1.0)

    # BFS from the sink set over the branching graph; unreachable rows are
    # dropped (Pfold.f90:115-180)
    dist = np.full(n, np.iinfo(np.int64).max)
    dist[np.nonzero(sink)[0]] = 0
    frontier = np.nonzero(sink)[0]
    # reverse reachability: m reaches the sink set through its OUT edges, so
    # walk the transpose graph from the sinks
    tr_ptr, tr_idx, _ = coo_to_csr_arrays(col, row, val, (n, n))
    d = 0
    while frontier.size:
        d += 1
        nbrs = np.concatenate(
            [tr_idx[tr_ptr[f] : tr_ptr[f + 1]] for f in frontier]
        ) if frontier.size else np.empty(0, np.int64)
        nbrs = np.unique(nbrs)
        new = nbrs[dist[nbrs] > d]
        dist[new] = d
        frontier = new
    unreachable = dist == np.iinfo(np.int64).max
    if unreachable.any():
        keep = ~unreachable[np.repeat(np.arange(n), np.diff(indptr))]
        rows2 = np.repeat(np.arange(n), np.diff(indptr))[keep]
        indptr, indices, data = coo_to_csr_arrays(
            rows2, indices[keep], data[keep], (n, n)
        )
    has_row = np.diff(indptr) > 0
    return indptr, indices, data, has_row, sink


@dataclasses.dataclass
class PfoldResult:
    committor: np.ndarray
    npfold: int
    nmin: int
    nnz: int
    time_s: float
    residual: float  # ||q - Dq|| over live rows at the end
    detailed_balance: Optional[float] = None


def pfold(
    db: MinDatabase,
    *,
    temperature: float,
    direction: str = "AB",
    npfold: int = 10000,
    nconnmin: int = 0,
    dtype: str = "f64",
    q0: Optional[np.ndarray] = None,
    device="cuda",
) -> PfoldResult:
    """NPFOLD Jacobi committor sweeps on the device (Pfold.f90:213-229).
    `time_s` spans the sweeps and the read of q, after an untimed warm-up
    of a few sweeps (the first launches load the kernels and grow the
    allocator) whose result is dropped."""
    indptr, indices, data, has_row, sink = branching_matrix(
        db, temperature=temperature, direction=direction, nconnmin=nconnmin
    )
    n = db.nmin
    plan = SpmvPlan(indptr, indices, data, (n, n), dtype=dtype, device=device)

    if q0 is None:
        q0 = np.zeros(n)
        q0[np.nonzero(sink)[0]] = 1.0  # setup.f:1417-1424
    qd = plan.vec_in(q0)
    mask = torch.as_tensor(has_row, device=plan.device)

    q = qd
    for _ in range(min(npfold, 8)):  # untimed warm-up
        q = torch.where(mask, plan.matvec_with(plan.A, q), q)
    plan.vec_out(q)

    t0 = time.perf_counter()
    q = qd
    for _ in range(npfold):
        # spmv.f90:15 skips empty rows
        q = torch.where(mask, plan.matvec_with(plan.A, q), q)
    q_host = plan.vec_out(q)
    t = time.perf_counter() - t0

    resid = plan.vec_out(plan.matvec_with(plan.A, q)) - q_host
    resid = float(np.linalg.norm(resid[has_row]))
    return PfoldResult(
        committor=q_host,
        npfold=npfold,
        nmin=n,
        nnz=len(indices),
        time_s=t,
        residual=resid,
    )


# ---------------------------------------------------------------------------
# synthetic landscape (tests; LJ38 min.data/ts.data blobs are stripped)
# ---------------------------------------------------------------------------


def synthetic_landscape(
    nmin: int = 500, nts: int = 2000, na: int = 5, nb: int = 20, seed: int = 0
) -> MinDatabase:
    """Random connected stationary-point database with LJ38-like scales."""
    rng = np.random.default_rng(seed)
    emin = rng.normal(-170.0, 1.0, nmin)
    fvib = rng.normal(300.0, 5.0, nmin)
    horder = rng.integers(1, 4, nmin).astype(np.int64)
    # spanning tree + random extra edges => connected
    perm = rng.permutation(nmin)
    tree_child = perm[1:]
    tree_parent = perm[np.asarray([rng.integers(0, i + 1) for i in range(nmin - 1)])]
    extra = rng.integers(0, nmin, size=(max(nts - (nmin - 1), 0), 2))
    extra = extra[extra[:, 0] != extra[:, 1]]
    plus = np.concatenate([tree_child, extra[:, 0]])
    minus = np.concatenate([tree_parent, extra[:, 1]])
    m = len(plus)
    barrier = rng.uniform(0.5, 3.0, m)
    ets = np.maximum(emin[plus], emin[minus]) + barrier
    fvibts = rng.normal(295.0, 5.0, m)
    hts = np.ones(m, dtype=np.int64)
    a_set = np.arange(na)
    b_set = np.arange(na, na + nb)
    return MinDatabase(emin, fvib, horder, ets, fvibts, hts, plus, minus, a_set, b_set)


def dense_committor(db: MinDatabase, *, temperature: float, direction="AB",
                    nconnmin: int = 0) -> np.ndarray:
    """Reference solution: fixed point q = D q with sinks pinned (host)."""
    indptr, indices, data, has_row, sink = branching_matrix(
        db, temperature=temperature, direction=direction, nconnmin=nconnmin
    )
    n = db.nmin
    D = np.zeros((n, n))
    rows = np.repeat(np.arange(n), np.diff(indptr))
    D[rows, indices] = data
    # solve (I - D) q = 0 with pinned rows: rows without entries keep q0
    q0 = np.zeros(n)
    q0[np.nonzero(sink)[0]] = 1.0
    A = np.eye(n) - D
    A[~has_row, :] = 0.0
    A[~has_row, ~has_row] = 1.0
    b = np.where(has_row, 0.0, q0)
    return np.linalg.solve(A, b)


# ---------------------------------------------------------------------------
# NGT — graph-transformation rate calculation (NGT.f)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NGTResult:
    kAB: float  # NSS rate A<-B (NGT.f:520-560 semantics)
    kBA: float
    kSSAB: float
    kSSBA: float
    detailed_balance: float  # kSSAB·Z_B / (kSSBA·Z_A) — exactly 1 for TST
    detailed_balance_nss: float  # same for kNSS ('1 if SS applies', NGT.f:937)
    p_ba: np.ndarray  # committor sums per A minimum (P_Ba)
    p_ab: np.ndarray  # per B minimum (P_Ab)
    tau: np.ndarray  # renormalised waiting times over A∪B
    committor: Optional[np.ndarray]  # seeded pfold sweep result
    time_s: float


def _branching_full(db: MinDatabase, temperature: float, nconnmin: int):
    """Branching probabilities WITHOUT sinks (NGT keeps every connected
    row and allows return to the start, NGT.f:118-129) + waiting times
    tau = exp(-lksum) (NGT.f:95)."""
    n = db.nmin
    kplus, kminus = log_rates(db, temperature)
    lnconn, _ = connectivity_census(db, nconnmin)
    dead = (db.plus == db.minus) | (lnconn[db.plus] <= nconnmin) | (
        lnconn[db.minus] <= nconnmin
    )
    live = ~dead
    lksum = np.zeros(n)
    np.add.at(lksum, db.plus[live], np.exp(kplus[live]))
    np.add.at(lksum, db.minus[live], np.exp(kminus[live]))
    with np.errstate(divide="ignore"):
        tau = np.where(lksum > 0, 1.0 / lksum, 0.0)
        llog = np.where(lksum > 0, np.log(lksum), 0.0)
    P = [dict() for _ in range(n)]
    for src, dst, k in ((db.plus, db.minus, kplus), (db.minus, db.plus, kminus)):
        ok = live & (lnconn[src] > nconnmin)
        for s, d_, kk in zip(src[ok], dst[ok], k[ok]):
            P[s][d_] = min(P[s].get(d_, 0.0) + np.exp(kk - llog[s]), 1.0)
    return P, tau, lnconn


def _gt_remove(P, tau, keep: np.ndarray, order):
    """Remove nodes in `order`, renormalising neighbours (NGTremovei.f90 +
    NGTrenorm: P(u→v) += P(u→x)·P(x→v)/(1−Pxx), τ(u) += P(u→x)·τ(x)/(1−Pxx))."""
    for x in order:
        row = P[x]
        pxx = row.get(x, 0.0)
        if pxx > 0.99:
            denom = sum(v for j, v in row.items() if j != x)
        else:
            denom = 1.0 - pxx
        if denom <= 0.0:
            raise FloatingPointError(f"NGT: 1-P_xx underflow at node {x}")
        fac = 1.0 / denom
        nbrs = [j for j in row if j != x]
        for u in nbrs:
            pux = P[u].pop(x, 0.0)
            if pux == 0.0:
                continue
            tau[u] = tau[u] + pux * tau[x] * fac
            for v in nbrs:
                P[u][v] = P[u].get(v, 0.0) + pux * row[v] * fac
        P[x] = {}
    return P, tau


def ngt(
    db: MinDatabase,
    *,
    temperature: float,
    nconnmin: int = 0,
    direction: str = "BA",
    npfold: int = 0,
    dtype: str = "f64",
    device="cuda",
) -> NGTResult:
    """NGT rate calculation (NGT.f): GT-remove all intermediate minima,
    read off committor sums and SS/NSS rates, optionally run the seeded
    pfold sweep (NGT.f:968-1013) on `device`."""
    t0 = time.perf_counter()
    n = db.nmin
    P, tau, lnconn = _branching_full(db, temperature, nconnmin)
    tau0 = tau.copy()  # PEMKSUM (pre-GT waiting times) for the SS rates

    is_ab = np.zeros(n, dtype=bool)
    is_ab[db.a_set] = True
    is_ab[db.b_set] = True
    inter = [
        j
        for j in range(n - 1, -1, -1)
        if not is_ab[j] and lnconn[j] > nconnmin
    ]  # removed from the bottom up (NGTremovei.f90:12)
    P, tau = _gt_remove(P, tau, is_ab, inter)

    # equilibrium weights (setup.f:745, 782-792)
    pfmin = -db.emin / temperature - db.fvib / 2.0 - np.log(db.horder.astype(float))
    def logsum(ix):
        m = pfmin[ix].max()
        return m + np.log(np.exp(pfmin[ix] - m).sum())
    pftotala, pftotalb = logsum(db.a_set), logsum(db.b_set)

    in_b = np.zeros(n, dtype=bool)
    in_b[db.b_set] = True
    in_a = np.zeros(n, dtype=bool)
    in_a[db.a_set] = True

    p_ba = np.zeros(len(db.a_set))
    kBA = kSSBA = 0.0
    for i, a in enumerate(db.a_set):
        commit = sum(v for j, v in P[a].items() if in_b[j])
        p_ba[i] = commit
        if tau[a] > 0:
            kBA += commit * np.exp(pfmin[a] - pftotala) / tau[a]
        if tau0[a] > 0:
            kSSBA += commit * np.exp(pfmin[a] - pftotala) / tau0[a]
    p_ab = np.zeros(len(db.b_set))
    kAB = kSSAB = 0.0
    for i, b in enumerate(db.b_set):
        commit = sum(v for j, v in P[b].items() if in_a[j])
        p_ab[i] = commit
        if tau[b] > 0:
            kAB += commit * np.exp(pfmin[b] - pftotalb) / tau[b]
        if tau0[b] > 0:
            kSSAB += commit * np.exp(pfmin[b] - pftotalb) / tau0[b]

    # detailed-balance checks (NGT.f:936-937): the kSS ratio is an exact
    # invariant of TST rates; the kNSS one holds only when the steady-state
    # approximation applies (the reference prints both as soft checks)
    ratio = kSSAB * np.exp(pftotalb - pftotala) / kSSBA if kSSBA > 0 else np.nan
    ratio_nss = kAB * np.exp(pftotalb - pftotala) / kBA if kBA > 0 else np.nan

    committor = None
    if npfold > 0:
        # seeded sweep: GPFOLD at A/B minima initialised from the GT
        # committors (NGT.f:462-468, 520-526), then the standard loop
        q0 = np.zeros(n)
        if direction == "AB":
            q0[db.a_set] = p_ba * 0 + 1.0  # A sinks hold 1 for PFA
            q0[db.b_set] = p_ab
        else:
            q0[db.a_set] = p_ba
            q0[db.b_set] = 1.0
        r = pfold(
            db,
            temperature=temperature,
            direction=direction,
            npfold=npfold,
            nconnmin=nconnmin,
            dtype=dtype,
            q0=q0,
            device=device,
        )
        committor = r.committor

    return NGTResult(
        kAB=kAB,
        kBA=kBA,
        kSSAB=kSSAB,
        kSSBA=kSSBA,
        detailed_balance=float(ratio),
        detailed_balance_nss=float(ratio_nss),
        p_ba=p_ba,
        p_ab=p_ab,
        tau=tau,
        committor=committor,
        time_s=time.perf_counter() - t0,
    )


def write_commit_data(path: str, committor: np.ndarray) -> None:
    """commit.data output (NGT.f:1014-1019 / Pfold output convention)."""
    with open(path, "w") as f:
        for v in committor:
            f.write(f"{v:20.10G}\n")


# ---------------------------------------------------------------------------
# TFOLD — mean-first-passage-time iteration (Pfold.f90 SUBROUTINE TFOLD)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TfoldResult:
    mfpt: np.ndarray  # [nmin] mean first passage time to the sink set
    kAB: float  # occupation-weighted rate over the source set
    iterations: int
    time_s: float


def tfold(
    db: MinDatabase,
    *,
    temperature: float,
    direction: str = "AB",
    ntfold: int = 10000,
    nconnmin: int = 0,
    dtype: str = "f64",
    device="cuda",
) -> TfoldResult:
    """MFPT to the sink set by first-step iteration t ← τ + D·t (the
    reference runs Gauss-Seidel/SOR, Pfold.f90 TFOLD:304-341; this is the
    Jacobi form of the same fixed point, as in the JAX package, with sinks
    pinned at 0 and rowless minima at τ). kAB = Σ_{b∈B} exp(pfmin_b −
    pftotal_B)/t(b)."""
    t0 = time.perf_counter()
    indptr, indices, data, has_row, sink = branching_matrix(
        db, temperature=temperature, direction=direction, nconnmin=nconnmin,
        block_opposite=False,
    )
    n = db.nmin
    kplus, kminus = log_rates(db, temperature)
    lnconn, _ = connectivity_census(db, nconnmin)
    dead = (db.plus == db.minus) | (lnconn[db.plus] <= nconnmin) | (
        lnconn[db.minus] <= nconnmin
    )
    live = ~dead
    lksum = np.zeros(n)
    np.add.at(lksum, db.plus[live], np.exp(kplus[live]))
    np.add.at(lksum, db.minus[live], np.exp(kminus[live]))
    with np.errstate(divide="ignore"):
        tau = np.where(lksum > 0, 1.0 / lksum, 0.0)
    tau = np.where(sink, 0.0, tau)  # sinks absorb instantly

    plan = SpmvPlan(indptr, indices, data, (n, n), dtype=dtype, device=device)
    taud = plan.vec_in(tau)
    mask = torch.as_tensor(has_row & ~sink, device=plan.device)
    # pinned value: 0 on sinks, tau on rowless minima
    pinned = torch.where(torch.as_tensor(sink, device=plan.device), 0.0, taud)

    t_dev = plan.vec_in(tau)
    for _ in range(ntfold):
        t_dev = torch.where(mask, taud + plan.matvec_with(plan.A, t_dev), pinned)
    mfpt = plan.vec_out(t_dev)
    el = time.perf_counter() - t0

    pfmin = -db.emin / temperature - db.fvib / 2.0 - np.log(db.horder.astype(float))
    src = db.b_set if direction == "AB" else db.a_set
    m = pfmin[src].max()
    pftotal = m + np.log(np.exp(pfmin[src] - m).sum())
    with np.errstate(divide="ignore"):
        kab = float(
            np.sum(np.exp(pfmin[src] - pftotal) / np.where(mfpt[src] > 0, mfpt[src], np.inf))
        )
    return TfoldResult(mfpt=mfpt, kAB=kab, iterations=ntfold, time_s=el)
