"""Kernel auto-selection: the learned backend gate.

Counterpart of lilac_tpu/autotune/__init__.py. The reference ships a
generated linear SVC that picks the SpMV backend from (log rows, log nnz)
(libspmv/mkl-model.c:3-165, trained by results/cgo/suite.py:75-109). Here:

* features(...)       (log rows, log nnz, log mean row length, row-length
                      cv, log density);
* measure(...)        times every registry kernel on a matrix on the card
                      (the results/cgo/run_all collection step);
* train(...)          one-vs-rest ridge classifier in closed form (numpy);
* LinearSelector      standardisation constants + weights, JSON;
* predict(...)        the gate SpmvPlan asks when a model is installed
                      and passes the ship gate;
* corpus_v2 / collect_rows / build_model_v2  the generated corpus, its
                      resumable on-card collection and the held-out
                      training with the ship-gate baselines.

The host functions are the JAX package's, bit for bit. The JAX package's
corpus and model were measured on a TPU and are not read here. Every row
names the card it was timed on (`device`), a rows file holds one card's
rows, and the default paths are the package's own, whatever the working
directory. The package ships the rows of an H100 (rows_h100.jsonl) and the
model trained on them (model.json), whose meta names that card: the model
serves only there, only if it passes its ship gate, and only for a matrix
inside its corpus (no more rows or entries than the largest row it was
trained on); elsewhere the heuristic serves.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

MODEL_ENV = "LILAC_AUTOTUNE_MODEL"
DEFAULT_MODEL_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "model.json")
DEFAULT_ROWS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rows_h100.jsonl")


def features(nrows: int, nnz: int, mean_row: float, std_row: float) -> np.ndarray:
    mean_row = max(mean_row, 1e-12)
    return np.asarray(
        [
            np.log(max(nrows, 1)),
            np.log(max(nnz, 1)),
            np.log(mean_row),
            std_row / mean_row,  # row-length coefficient of variation
            np.log(max(nnz, 1) / max(nrows, 1) ** 2 + 1e-300),  # density
        ]
    )


@dataclasses.dataclass
class LinearSelector:
    classes: List[str]
    mean: np.ndarray  # [f] standardisation (mkl-model.c:157-161 analogue)
    scale: np.ndarray  # [f]
    W: np.ndarray  # [classes, f]
    b: np.ndarray  # [classes]

    def predict(self, feat: np.ndarray) -> str:
        z = (feat - self.mean) / self.scale
        return self.classes[int(np.argmax(self.W @ z + self.b))]

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                dict(
                    classes=self.classes,
                    mean=self.mean.tolist(),
                    scale=self.scale.tolist(),
                    W=self.W.tolist(),
                    b=self.b.tolist(),
                ),
                f,
                indent=1,
            )

    @staticmethod
    def load(path: str) -> "LinearSelector":
        with open(path) as f:
            d = json.load(f)
        return LinearSelector(
            d["classes"],
            np.asarray(d["mean"]),
            np.asarray(d["scale"]),
            np.asarray(d["W"]),
            np.asarray(d["b"]),
        )


def train(X: np.ndarray, labels: Sequence[str], ridge: float = 1e-3) -> LinearSelector:
    """One-vs-rest ridge classifier in closed form (suite.py:75-81's role)."""
    X = np.asarray(X, dtype=np.float64)
    classes = sorted(set(labels))
    mean = X.mean(axis=0)
    scale = X.std(axis=0)
    scale[scale == 0] = 1.0
    Z = (X - mean) / scale
    Za = np.concatenate([Z, np.ones((len(Z), 1))], axis=1)
    Wb = np.zeros((len(classes), Za.shape[1]))
    G = Za.T @ Za + ridge * np.eye(Za.shape[1])
    for i, c in enumerate(classes):
        y = np.where(np.asarray(labels) == c, 1.0, -1.0)
        Wb[i] = np.linalg.solve(G, Za.T @ y)
    return LinearSelector(classes, mean, scale, Wb[:, :-1], Wb[:, -1])


def device_name(device="cuda") -> str:
    """The name a row records for `device`: the card's, or "cpu"."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def measure(
    indptr, indices, data, shape, kernels: Sequence[str], *, dtype="f32", reps=10,
    device="cuda",
) -> Dict[str, float]:
    """Seconds a matvec of each kernel takes on a square matrix: a chain of
    `reps` matvecs between two synchronisations, after one untimed chain.
    A kernel whose container refuses the matrix (SpmvPlan's ValueError) or
    does not fit the device's memory with its product (torch's
    OutOfMemoryError: plain ELL of a power-law graph pads every row to the
    longest) does not apply and is left out; any other failure, a kernel
    that does not build or launch included, raises."""
    from lilac_tpu_torch.plan import SpmvPlan
    from lilac_tpu_torch.utils.profiling import timed_chain

    dev = torch.device(device)
    out = {}
    for k in kernels:
        try:
            try:
                plan = SpmvPlan(indptr, indices, data, shape, dtype=dtype, kernel=k,
                                device=dev)
            except ValueError:
                continue
            x = plan.vec_in(np.random.default_rng(0).normal(size=shape[1]))
            out[k] = timed_chain(lambda v, plan=plan: plan.matvec_with(plan.A, v),
                                 x, reps)
        except torch.OutOfMemoryError:
            plan = x = None
            torch.cuda.empty_cache()
    return out


_cached_model: Optional[LinearSelector] = None
_cached_path: Optional[str] = None
_cached_meta: dict = {}  # the cached model's meta: its card, its corpus's extent


def heuristic_label(nrows: int, ncols: int, mean_row: float, std_row: float,
                    max_row: Optional[float] = None) -> str:
    """The model-free gate SpmvPlan falls back to (reuse='many', f32, on an
    accelerator): routed below the one-table bound, else the ELL family by
    row spread. The ship baseline of trained models: a selector that cannot
    beat this (or the majority class) must not install."""
    if ncols <= (1 << 18):
        return "routed"
    if max_row is None:
        max_row = mean_row + 3.0 * std_row  # spread proxy for stored rows
    return "xla_sell" if max_row > 1.5 * max(mean_row, 1.0) + 4 else "xla_ell"


def installed_model(device) -> Optional[LinearSelector]:
    """The model at cfg().autotune_model (default DEFAULT_MODEL_PATH) that
    serves on `device`, or None when there is none or it fails the ship
    gate: a model whose recorded held-out accuracy does not beat both the
    majority-class and the heuristic baselines is ignored, and the
    heuristic serves.

    A model whose meta names a card serves only where `device` is that card
    (device_name; the CPU is none): one card's timings say nothing of
    another device. A model whose meta names none serves anywhere."""
    global _cached_model, _cached_path, _cached_meta
    from lilac_tpu_torch.config import cfg

    path = cfg().autotune_model or DEFAULT_MODEL_PATH
    if not os.path.exists(path):
        return None
    if _cached_model is None or _cached_path != path:
        with open(path) as f:
            meta = json.load(f).get("meta", {})
        acc = meta.get("test_accuracy")
        bars = [meta.get("majority_accuracy"), meta.get("heuristic_accuracy")]
        bars = [b for b in bars if b is not None]
        if acc is not None and bars and acc <= max(bars):
            _cached_model, _cached_path = None, path
            return None
        _cached_model = LinearSelector.load(path)
        _cached_path = path
        _cached_meta = meta
    card = _cached_meta.get("device")
    if card is not None:
        dev = torch.device(device)
        # a CUDA device where torch sees no card is no card the model names
        here = (device_name(dev) if dev.type != "cuda" or torch.cuda.is_available()
                else None)
        if here != card:
            return None
    return _cached_model


def predict(nrows, nnz, mean_row, std_row, device) -> Optional[str]:
    """Model-gated kernel choice; None when no model serves on `device`
    (installed_model) or the matrix lies beyond the model's corpus: more
    rows or entries than the largest of the rows it was trained on (meta
    corpus_max_nrows, corpus_max_nnz), where its timings say nothing."""
    m = installed_model(device)
    if m is None:
        return None
    if nrows > _cached_meta.get("corpus_max_nrows", nrows) \
            or nnz > _cached_meta.get("corpus_max_nnz", nnz):
        return None
    return m.predict(features(nrows, nnz, mean_row, std_row))


def corpus_v2(max_n: int = 250_000, seeds: int = 3):
    """The generated corpus spanning the reference's SuiteSparse axes
    (results/cgo/all_matrices.csv: 1e2..1e7 rows, densities 1e-6..1e-1, row
    spread from stencil-uniform to web-graph power law), the JAX package's
    matrices bit for bit.

    Yields (name, (indptr, indices, data, shape)) lazily: callers that time
    on the device iterate and discard, which bounds host memory."""
    from lilac_tpu_torch.formats.convert import coo_to_csr_arrays
    from lilac_tpu_torch.generate.graphs import powerlaw_graph
    from lilac_tpu_torch.generate.random_crs import random_crs
    from lilac_tpu_torch.generate.stencil import seven_point_csr

    # 3D 7-point stencils (uniform rows, ELL-perfect)
    for side in (8, 12, 16, 20, 25, 30, 36, 42, 50, 58, 62):
        if side**3 <= max_n:
            yield f"st3d_{side}", seven_point_csr(side, side, side)
    # anisotropic 3D + 2D 5-point sheets (n3=1 kills the k-axis couplings)
    for dims in ((64, 16, 8), (128, 32, 4), (256, 64, 2), (512, 16, 16),
                 (100, 100, 1), (224, 224, 1), (350, 350, 1), (500, 500, 1),
                 (2048, 32, 1), (8192, 8, 1)):
        n = dims[0] * dims[1] * dims[2]
        if n <= max_n:
            yield f"st_{dims[0]}x{dims[1]}x{dims[2]}", seven_point_csr(*dims)
    # banded (uniform K = bw)
    for n in (4096, 16384, 65536, 200_000):
        for bw in (3, 5, 9, 17, 33, 65):
            if n > max_n:
                continue
            offs = np.arange(-(bw // 2), bw // 2 + 1)
            rows = np.repeat(np.arange(n), bw)
            cols = (rows.reshape(n, bw) + offs).clip(0, n - 1).ravel()
            vals = np.random.default_rng(n + bw).normal(size=n * bw)
            yield f"band{n}_{bw}", coo_to_csr_arrays(rows, cols, vals, (n, n)) + ((n, n),)
    # big_gen-style random CRS (Poisson-ish spread), several densities
    for size in (8, 12, 16, 20, 24, 28, 32, 36, 40, 46, 52, 58, 62):
        for mean, std in ((3.0, 2.0), (5.0, 4.0), (9.0, 6.0), (15.0, 8.0)):
            if size**3 <= max_n:
                for s in range(seeds):
                    yield (f"rc{size}_m{int(mean)}_s{s}",
                           random_crs(size, seed=17 * s + size, mean_nnz=mean,
                                      std_nnz=std))
    # power-law graphs (heavy-tailed rows: the SELL / routed regime)
    for n in (4096, 16384, 65536, 150_000):
        for deg in (4, 8, 16):
            for alpha in (1.9, 2.3):
                for s in range(max(1, seeds - 1)):
                    if n <= max_n:
                        yield (f"pl{n}_d{deg}_a{alpha}_s{s}",
                               powerlaw_graph(n, avg_deg=deg, alpha=alpha,
                                              seed=n + deg + 1000 * s))
    # NPB makea factor patterns V / V^T (Poisson row spread on the VT side)
    from lilac_tpu_torch.generate.npb import CLASSES, _generate_triples

    for cname in ("S", "W"):
        cls = CLASSES[cname]
        if cls.na > max_n:
            continue
        nzv_arr, ivc, _vc = _generate_triples(cls)
        rows_i = np.repeat(np.arange(cls.na, dtype=np.int64), nzv_arr)
        pos_j = (ivc - 1).astype(np.int64)
        vv = np.random.default_rng(3).normal(size=len(rows_i))
        sh = (cls.na, cls.na)
        yield f"npbV_{cname}", coo_to_csr_arrays(rows_i, pos_j, vv, sh) + (sh,)
        yield f"npbVT_{cname}", coo_to_csr_arrays(pos_j, rows_i, vv, sh) + (sh,)
    # block-dense diagonals (BSR-friendly, perfectly uniform)
    for nb, b in ((256, 8), (512, 16), (1024, 32), (4096, 8), (2048, 16)):
        n = nb * b
        if n > max_n:
            continue
        base = np.arange(nb, dtype=np.int64)[:, None, None] * b
        rows = (base + np.arange(b)[:, None]).repeat(b, axis=2).ravel()
        cols = np.broadcast_to(base + np.arange(b)[None, :], (nb, b, b)).ravel()
        vals = np.random.default_rng(b).normal(size=nb * b * b)
        yield f"bdiag{nb}x{b}", coo_to_csr_arrays(rows, cols, vals, (n, n)) + ((n, n),)
    # bimodal spread: most rows tiny, a hot minority wide (web-like)
    for n in (8192, 65536, 200_000):
        for hotfrac, hotk in ((0.1, 128), (0.02, 400)):
            if n > max_n:
                continue
            rng = np.random.default_rng(n + hotk)
            counts = np.full(n, 2, dtype=np.int64)
            hot = rng.choice(n, size=max(1, int(n * hotfrac)), replace=False)
            counts[hot] = hotk
            rows = np.repeat(np.arange(n), counts)
            cols = rng.integers(0, n, size=counts.sum())
            vals = rng.normal(size=len(cols))
            yield (f"bimod{n}_{hotk}",
                   coo_to_csr_arrays(rows, cols, vals, (n, n)) + ((n, n),))
    # near-diagonal / ultra-sparse
    for n in (10_000, 100_000):
        idx = np.arange(n, dtype=np.int64)
        vals = np.random.default_rng(1).normal(size=n)
        yield f"diag{n}", coo_to_csr_arrays(idx, idx, vals, (n, n)) + ((n, n),)


def default_corpus(max_n: int = 200_000):
    """The first, smaller generated corpus: stencils, random CRS at several
    densities, banded matrices; the JAX package's bit for bit."""
    from lilac_tpu_torch.formats.convert import coo_to_csr_arrays
    from lilac_tpu_torch.generate.random_crs import random_crs
    from lilac_tpu_torch.generate.stencil import seven_point_csr

    corpus = []
    for side in (10, 16, 24, 32, 40):
        if side**3 <= max_n:
            corpus.append(("stencil", seven_point_csr(side, side, side)))
    for size, seed in ((10, 0), (20, 1), (30, 2), (40, 3)):
        if size**3 <= max_n:
            corpus.append((f"randcrs{size}", random_crs(size, seed=seed)))
    # banded matrices with wide bands (ELL-friendly)
    for n, bw in ((20_000, 9), (50_000, 17)):
        if n <= max_n:
            offs = np.arange(-(bw // 2), bw // 2 + 1)
            rows = np.repeat(np.arange(n), bw)
            cols = (rows.reshape(n, bw) + offs).clip(0, n - 1).ravel()
            vals = np.random.default_rng(n).normal(size=n * bw)
            corpus.append((f"band{n}", coo_to_csr_arrays(rows, cols, vals, (n, n)) + ((n, n),)))
    return corpus


def build_default_model(
    kernels=("xla_ell", "xla_sell", "xla_csr"), path: str = DEFAULT_MODEL_PATH,
    reps: int = 20, verbose: bool = True, device="cuda",
):
    """Measure default_corpus on `device`, train, and save the model: the
    whole results/cgo pipeline (run_all -> suite.py -> mkl-model.c) in one
    call."""
    X, y = [], []
    for name, (indptr, indices, data, shape) in default_corpus():
        times = measure(indptr, indices, data, shape, kernels, reps=reps, device=device)
        if not times:
            continue
        best = min(times, key=times.get)
        counts = np.diff(indptr)
        X.append(
            features(shape[0], len(indices), float(counts.mean()), float(counts.std()))
        )
        y.append(best)
        if verbose:
            print(f"  {name:12s} -> {best:10s} " + " ".join(
                f"{k}={v*1e3:.2f}ms" for k, v in sorted(times.items())))
    model = train(np.asarray(X), y)
    model.save(path)
    if verbose:
        acc = np.mean([model.predict(x) == l for x, l in zip(X, y)])
        print(f"model saved to {path}; train accuracy {acc:.2f}")
    return model


def _read_rows(jsonl_path: str) -> list:
    with open(jsonl_path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def collect_rows(
    jsonl_path: str = DEFAULT_ROWS_PATH,
    kernels: Sequence[str] = ("xla_ell", "xla_sell", "xla_csr", "routed"),
    *,
    max_n: int = 250_000,
    dtype: str = "f32",
    reps: int = 20,
    budget_s: Optional[float] = None,
    verbose: bool = True,
    device="cuda",
):
    """Time the corpus_v2 matrices on `device`, appending one JSON row a
    matrix to jsonl_path; returns the count of new rows. Each row names its
    card (`device`). Resumable: a matrix already timed on this card is
    skipped. A file holding rows of another card (or rows that name none)
    is refused: one file holds one card's rows."""
    t0 = time.time()
    here = device_name(device)
    done = set()
    if os.path.exists(jsonl_path):
        for r in _read_rows(jsonl_path):
            if r.get("device") != here:
                raise ValueError(
                    f"{jsonl_path} holds a row of device {r.get('device')!r} "
                    f"({r.get('name')!r}); this run times {here!r}: use a rows "
                    "file of its own")
            done.add(r["name"])
    n_new = 0
    for name, (indptr, indices, data, shape) in corpus_v2(max_n=max_n):
        if name in done:
            continue
        if budget_s is not None and time.time() - t0 > budget_s:
            if verbose:
                print(f"collect_rows: budget reached after {n_new} new rows")
            break
        counts = np.diff(indptr)
        feat = features(
            shape[0], len(indices), float(counts.mean()), float(counts.std())
        )
        times = measure(
            indptr, indices, data, shape, kernels, dtype=dtype, reps=reps, device=device
        )
        if not times:
            continue
        row = dict(
            name=name,
            feat=[float(v) for v in feat],
            times={k: float(v) for k, v in times.items()},
            nrows=int(shape[0]),
            ncols=int(shape[1]),
            nnz=int(len(indices)),
            device=here,
        )
        with open(jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        n_new += 1
        if verbose:
            best = min(times, key=times.get)
            print(f"  {name:16s} -> {best:10s} " + " ".join(
                f"{k}={v*1e3:.3f}ms" for k, v in sorted(times.items())),
                flush=True)
    return n_new


def build_model_v2(
    jsonl_path: str = DEFAULT_ROWS_PATH,
    path: str = DEFAULT_MODEL_PATH,
    *,
    holdout: float = 0.25,
    seed: int = 0,
    verbose: bool = True,
) -> LinearSelector:
    """Train from collected rows with held-out splits and record the
    held-out accuracy and the ship-gate baselines in the model JSON (the
    reference's train / test protocol, suite.py:97-102). The rows must all
    name one card, which the meta records with the corpus's largest row
    and entry counts."""
    rows = _read_rows(jsonl_path)
    devices = sorted({str(r.get("device")) for r in rows})
    if len(devices) != 1 or any("device" not in r for r in rows):
        raise ValueError(f"{jsonl_path}: rows of devices {devices}; a model is "
                         "trained on one card's rows, each naming it")
    X = np.asarray([r["feat"] for r in rows])
    y = [min(r["times"], key=r["times"].get) for r in rows]
    # small corpora: one split of max(1, 0.25 n) rows is noise, so the
    # held-out accuracy is averaged over several random splits; large
    # corpora keep the reference's single split (suite.py:97-102)
    n_splits = 8 if len(rows) < 40 else 5 if len(rows) < 500 else 1
    accs_tr, accs_te = [], []
    for k in range(n_splits):
        rng = np.random.default_rng(seed + k)
        idx = rng.permutation(len(rows))
        n_test = max(1, int(len(rows) * holdout))
        test, tr = idx[:n_test], idx[n_test:]
        m_k = train(X[tr], [y[i] for i in tr])
        accs_tr.append(np.mean([m_k.predict(X[i]) == y[i] for i in tr]))
        accs_te.append(np.mean([m_k.predict(X[i]) == y[i] for i in test]))
    acc_tr = float(np.mean(accs_tr))
    acc_te = float(np.mean(accs_te))
    # refit on everything for the shipped weights; the held-out number is
    # the one measured before the refit
    model = train(X, y)
    model.save(path)
    with open(path) as f:
        meta = json.load(f)
    # ship-gate baselines: a model that cannot beat the constant majority
    # predictor or the model-free heuristic on the same corpus is worse
    # than none, and installed_model() refuses it
    counts = {c: y.count(c) for c in set(y)}
    majority_acc = max(counts.values()) / len(y)
    heur_hits = 0
    for r in rows:
        f = r["feat"]
        h = heuristic_label(
            r["nrows"], r.get("ncols", r["nrows"]),
            float(np.exp(f[2])), float(np.exp(f[2])) * f[3],
        )
        heur_hits += h == min(r["times"], key=r["times"].get)
    heuristic_acc = heur_hits / len(rows)
    meta["meta"] = dict(
        corpus_rows=len(rows),
        holdout_frac=holdout,
        holdout_splits=n_splits,
        train_accuracy=round(acc_tr, 4),
        test_accuracy=round(acc_te, 4),
        majority_accuracy=round(majority_acc, 4),
        heuristic_accuracy=round(heuristic_acc, 4),
        gated_ok=bool(acc_te > max(majority_acc, heuristic_acc)),
        label_counts={c: int(y.count(c)) for c in sorted(set(y))},
        source=os.path.basename(jsonl_path),
        device=devices[0],
        # the corpus's extent: predict() serves no matrix beyond it
        corpus_max_nrows=max(int(r["nrows"]) for r in rows),
        corpus_max_nnz=max(int(r["nnz"]) for r in rows),
    )
    with open(path, "w") as f:
        json.dump(meta, f, indent=1)
    if verbose:
        print(f"model v2 saved to {path}: rows={len(rows)} "
              f"train_acc={acc_tr:.3f} held-out_acc={acc_te:.3f} "
              f"majority={majority_acc:.3f} heuristic={heuristic_acc:.3f} "
              f"ships={'YES' if meta['meta']['gated_ok'] else 'NO (heuristic serves)'} "
              f"labels={meta['meta']['label_counts']}")
    return model
