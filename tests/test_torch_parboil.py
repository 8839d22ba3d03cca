"""lilac_tpu_torch Parboil path against the JAX package: the MatrixMarket
reader, Parboil's file formats and compare, parboil_spmv.run, and sgemm
with the plain version of kernel K12.

Host arrays (reader output, written files) must be bit-identical. The
spmv run is compared to 1e-6 of sum |a·x| per row (f32, summation orders
differ). A GEMM element is held to K·2^-24·(|A|·|B|ᵀ) + 2^-24·|C| of the
f64 product; the JAX Pallas kernel runs in interpret mode, as its own test
runs it on the CPU.
"""

import numpy as np
import pytest
import torch

from lilac_tpu.io import readers as jrd
from lilac_tpu.kernels import pallas_gemm as jgemm
from lilac_tpu.workloads import parboil_spmv as jpv
from lilac_tpu.workloads import sgemm as jsg
from lilac_tpu_torch.io import readers as trd
from lilac_tpu_torch.kernels import gemm as tgemm
from lilac_tpu_torch.workloads import parboil_spmv as tpv
from lilac_tpu_torch.workloads import sgemm as tsg

torch.set_num_threads(1)


def _write_mtx(path, field, symm, n=60, nnz=300, seed=0, comments=2):
    """A coordinate file: 1-based, duplicates included, lower triangle for
    the symmetric kinds (skew: no diagonal)."""
    rng = np.random.default_rng(seed)
    r = rng.integers(1, n + 1, size=nnz)
    c = rng.integers(1, n + 1, size=nnz)
    if symm != "general":
        r, c = np.maximum(r, c), np.minimum(r, c)
        if symm == "skew-symmetric":
            keep = r != c
            r, c = r[keep], c[keep]
    v = rng.standard_normal(len(r)) * 10.0 ** rng.integers(-3, 4, size=len(r))
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symm}\n")
        for i in range(comments):
            f.write(f"% comment line {i}\n")
        f.write(f"{n} {n} {len(r)}\n")
        for a, b, x in zip(r, c, v):
            f.write(f"{a} {b}\n" if field == "pattern" else f"{a} {b} {x:.17g}\n")
    return path


@pytest.mark.parametrize("field,symm", [
    ("real", "general"), ("real", "symmetric"), ("real", "skew-symmetric"),
    ("pattern", "general"), ("pattern", "symmetric"), ("integer", "general"),
])
def test_read_matrix_market_bit_identical(tmp_path, field, symm):
    path = _write_mtx(str(tmp_path / "a.mtx"), field, symm)
    want = jrd.read_matrix_market(path)
    got = trd.read_matrix_market(path)
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if symm == "symmetric":  # mirrored: A equals its transpose
        n = got[3][0]
        d = np.zeros((n, n))
        np.add.at(d, (np.repeat(np.arange(n), np.diff(got[0])), got[1]), got[2])
        np.testing.assert_array_equal(d, d.T)


def test_read_matrix_market_raises(tmp_path):
    bad = tmp_path / "b.mtx"
    bad.write_text("%%MatrixMarket matrix coordinate real general\n3 3 4\n1 1 1.0\n2 2 2.0\n")
    with pytest.raises(ValueError, match="parsed 2 of 4"):
        trd.read_matrix_market(str(bad))
    (tmp_path / "c.mtx").write_text("not a matrix\n")
    with pytest.raises(ValueError, match="not a MatrixMarket"):
        trd.read_matrix_market(str(tmp_path / "c.mtx"))
    (tmp_path / "d.mtx").write_text("%%MatrixMarket matrix array real general\n2 2\n")
    with pytest.raises(NotImplementedError):
        trd.read_matrix_market(str(tmp_path / "d.mtx"))


@pytest.mark.parametrize("pattern", [False, True])
def test_write_matrix_market_matches_reference(tmp_path, pattern):
    src = _write_mtx(str(tmp_path / "s.mtx"), "real", "symmetric", seed=3)
    ip, ix, dv, shape = trd.read_matrix_market(src)
    trd.write_matrix_market(str(tmp_path / "t.mtx"), ip, ix, dv, shape, pattern=pattern)
    jrd.write_matrix_market(str(tmp_path / "j.mtx"), ip, ix, dv, shape, pattern=pattern)
    assert (tmp_path / "t.mtx").read_bytes() == (tmp_path / "j.mtx").read_bytes()
    back = trd.read_matrix_market(str(tmp_path / "t.mtx"))
    np.testing.assert_array_equal(back[1], ix)
    np.testing.assert_array_equal(back[2], np.ones_like(dv) if pattern else dv)


def test_parboil_file_round_trips(tmp_path):
    rng = np.random.default_rng(4)
    y = rng.standard_normal(33).astype(np.float32)
    tpv.write_output(str(tmp_path / "t.out"), y)
    jpv.write_output(str(tmp_path / "j.out"), y)
    assert (tmp_path / "t.out").read_bytes() == (tmp_path / "j.out").read_bytes()
    np.testing.assert_array_equal(tpv.read_golden(str(tmp_path / "t.out")), y)
    y.tofile(str(tmp_path / "v.bin"))
    np.testing.assert_array_equal(tpv.read_vector_bin(str(tmp_path / "v.bin"), 33), y)
    with pytest.raises(ValueError, match="wanted 34"):
        tpv.read_vector_bin(str(tmp_path / "v.bin"), 34)
    M = rng.standard_normal((3, 5)).astype(np.float32)
    tsg.write_col_major(str(tmp_path / "t.txt"), M)
    jsg.write_col_major(str(tmp_path / "j.txt"), M)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    got = tsg.read_col_major(str(tmp_path / "t.txt"))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, M)
    np.testing.assert_array_equal(got, jsg.read_col_major(str(tmp_path / "t.txt")))


@pytest.mark.parametrize("case", ["equal", "abs", "rel", "off", "length", "zeros",
                                  "neg"])
def test_compare_matches_reference(case):
    rng = np.random.default_rng(5)
    ref = rng.standard_normal(100).astype(np.float32)
    got = ref.copy()
    if case == "abs":  # inside 1e-4 * max|ref|
        got[3] += 0.9e-4 * np.abs(ref).max()
    elif case == "rel":  # a large entry off by 0.1%
        ref[7] = 1e4
        got = ref.copy()
        got[7] *= 1.001
    elif case == "off":  # outside both: 10x the abs line on a small entry
        ref[9] = 0.01
        got = ref.copy()
        got[9] += 1e-3 * np.abs(ref).max()
    elif case == "length":
        got = got[:-1]
    elif case == "zeros":
        ref[:] = 0
        got = ref.copy()
    elif case == "neg":
        got = -got
    assert tpv.compare(ref, got) == jpv.compare(ref, got)
    assert tpv.compare(ref, got) == (case in ("equal", "abs", "rel", "zeros"))


def _spread_symmetric_mtx(path, n=3000, seed=6):
    """A symmetric file with unequal row lengths (a few long rows) and its
    golden output, from f64 host arithmetic rounded to f32."""
    rng = np.random.default_rng(seed)
    k = rng.integers(2, 12, size=n)
    k[rng.choice(n, size=20, replace=False)] = 80
    r = np.repeat(np.arange(n), k)
    c = rng.integers(0, n, size=len(r))
    r, c = np.maximum(r, c), np.minimum(r, c)
    v = rng.standard_normal(len(r))
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real symmetric\n")
        f.write(f"{n} {n} {len(r) + n}\n")
        f.write("".join(f"{i + 1} {i + 1} 4.0\n" for i in range(n)))
        f.write("".join(f"{a + 1} {b + 1} {x:.17g}\n" for a, b, x in zip(r, c, v)))
    return n


def test_parboil_spmv_run_matches_reference(tmp_path):
    mtx = str(tmp_path / "m.mtx")
    n = _spread_symmetric_mtx(mtx)
    x = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    x.tofile(str(tmp_path / "vector.bin"))
    ip, ix, dv, shape = trd.read_matrix_market(mtx)
    rows = np.repeat(np.arange(n), np.diff(ip))
    exact = np.bincount(rows, weights=dv * x.astype(np.float64)[ix], minlength=n)
    scale = np.bincount(rows, weights=np.abs(dv * x.astype(np.float64)[ix]), minlength=n)
    golden = str(tmp_path / "golden.out")
    tpv.write_output(golden, exact.astype(np.float32))
    kw = dict(golden_path=golden, reps=3)
    t = tpv.run(mtx, str(tmp_path / "vector.bin"), out_path=str(tmp_path / "t.out"),
                device="cpu", **kw)
    j = jpv.run(mtx, str(tmp_path / "vector.bin"), out_path=str(tmp_path / "j.out"),
                **kw)
    assert t.matched is True and j.matched is True
    assert t.kernel == "xla_sell" and t.plan.kernel == "xla_sell"  # rows spread
    assert (t.rows, t.nnz, t.reps) == (j.rows, j.nnz, j.reps) == (n, len(ix), 3)
    yt = tpv.read_golden(str(tmp_path / "t.out"))
    yj = jpv.read_golden(str(tmp_path / "j.out"))
    assert np.all(np.abs(yt.astype(np.float64) - yj) <= 1e-6 * scale)
    assert np.all(np.abs(yt - exact) <= 1e-6 * scale)
    assert t.time_s > 0 and np.isfinite(t.gflops)


def _gemm_bound(A, BT):
    """(f64 product, K·2^-24·(|A|·|B|ᵀ) + 2^-24·|C|)."""
    a64, b64 = A.astype(np.float64), BT.astype(np.float64)
    c = a64 @ b64.T
    u = 2.0 ** -24
    return c, A.shape[1] * u * (np.abs(a64) @ np.abs(b64).T) + u * np.abs(c)


@pytest.mark.parametrize("m,n,k", [(150, 90, 70), (300, 260, 600)])
def test_sgemm_matches_pallas_interpret(m, n, k):
    rng = np.random.default_rng(m)
    A = rng.standard_normal((m, k)).astype(np.float32)
    BT = rng.standard_normal((n, k)).astype(np.float32)
    c64, bound = _gemm_bound(A, BT)
    C, res = tsg.run_arrays(A, BT, device="cpu")
    assert (res.m, res.n, res.k, res.kernel) == (m, n, k, "cuda")
    plain = tgemm.matmul_nt_plain(torch.as_tensor(A), torch.as_tensor(BT)).numpy()
    np.testing.assert_array_equal(C, plain)  # a CPU tensor takes the plain version
    assert C.dtype == np.float32 and C.shape == (m, n)
    jc = np.asarray(jgemm.matmul_nt(A, BT))  # interpret mode on the CPU
    assert np.all(np.abs(jc - c64) <= bound)
    assert np.all(np.abs(C - c64) <= bound)
    assert np.all(np.abs(C.astype(np.float64) - jc) <= 2 * bound)
    assert tpv.compare(jc.ravel(), C.ravel())


def test_sgemm_torch_option_and_files(tmp_path):
    rng = np.random.default_rng(8)
    A = rng.standard_normal((17, 5)).astype(np.float32)
    BT = rng.standard_normal((33, 5)).astype(np.float32)
    c64, bound = _gemm_bound(A, BT)
    C, res = tsg.run_arrays(A, BT, kernel="torch", device="cpu")
    assert res.kernel == "torch" and np.all(np.abs(C - c64) <= bound)
    # the reference's names are taken (test_torch_formats_dense.py); a name
    # of neither package is refused
    with pytest.raises(ValueError, match="unknown sgemm kernel"):
        tsg.run_arrays(A, BT, kernel="mxu", device="cpu")
    for name, mat in (("a", A), ("bt", BT), ("c", c64.astype(np.float32))):
        tsg.write_col_major(str(tmp_path / f"{name}.txt"), mat)
    C2, _, matched = tsg.run(str(tmp_path / "a.txt"), str(tmp_path / "bt.txt"),
                             out_path=str(tmp_path / "out.txt"),
                             golden_path=str(tmp_path / "c.txt"), device="cpu")
    assert matched is True
    np.testing.assert_array_equal(tsg.read_col_major(str(tmp_path / "out.txt")), C2)
    with pytest.raises(ValueError, match="takes A"):
        tgemm.matmul_nt(torch.zeros(3, 4), torch.zeros(3, 5))
    with pytest.raises(ValueError, match="float32"):
        tgemm.matmul_nt(torch.zeros(3, 4, dtype=torch.float64), torch.zeros(3, 4))
