"""The port's distribution (lilac_tpu_torch.parallel: the mesh, run_spmd,
DistSpmvPlan, HaloSpmvPlan and the distributed solvers) against the JAX
package's lilac_tpu.parallel.

The port's ranks run on a Gloo group of CPU processes (run_spmd), spawned
once per group size for this module; parametrised tests read their
results. The JAX side runs in this process on make_mesh(4) of the
8-device virtual CPU mesh (tests/conftest.py). The rank functions live in
tests/torch_dist_ranks.py, which imports no JAX.

* The host arrays (the row-block ELL split, the halo tables) are the JAX
  package's bit for bit at 2, 4 and 8 ranks.
* Matvecs agree with the JAX package to tests/test_dist.py's tolerances:
  f32 3e-5, f64 1e-12, df64 5e-13 (rtol and atol).
* Solvers: NPB class S verifies (zeta rel. err <= 1e-10) in f64 and df64
  on 4 ranks; its zeta history agrees with the JAX package's to 1e-12
  relative (both verify far below NPB's 1e-10; the sums are taken in
  other orders) and its residual-norm history to 1e-12 absolute (norms of
  1e-13 to 1e-15: the sums' rounding, which differs by tens of percent). CG on an SPD system and BiCG
  with the staged transpose end within 1e-10 relative of the JAX package's
  solutions and within the JAX tests' tolerances of a direct solve.
* Every rank returns the same bits: the ordered-sum dot makes the
  replicated histories identical, not merely close.
* A world of one rank gives the single-process solver's bits.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import PartitionSpec as P

from lilac_tpu.formats.convert import dense_to_csr_arrays
from lilac_tpu.generate.npb import CLASSES, make_cg_matrix
from lilac_tpu.generate.stencil import seven_point_csr
from lilac_tpu.ops import dfloat as jdf
from lilac_tpu.parallel import dist as jd
from lilac_tpu.parallel import halo as jh
from lilac_tpu_torch.parallel import dist as td
from lilac_tpu_torch.parallel import halo as th
from lilac_tpu_torch.parallel import launch, mesh as tmesh
from lilac_tpu_torch.parallel.dryrun import dryrun_multichip
from lilac_tpu_torch.workloads import npb_cg
from tests import torch_dist_ranks as R
from tests.conftest import random_csr

torch.set_num_threads(1)

NDEV = 4
TOL = {"f32": 3e-5, "f64": 1e-12, "df64": 5e-13}  # tests/test_dist.py:52
ZETA_HIST_RTOL = 1e-12
RNORM_HIST_ATOL = 1e-12
SOLVE_RTOL = 1e-10


def _f64(v) -> np.ndarray:
    """A port result (array, or a DF of host arrays) as f64."""
    if isinstance(v, tuple):
        return v[0].astype(np.float64) + v[1].astype(np.float64)
    return np.asarray(v, dtype=np.float64)


def _jf64(v) -> np.ndarray:
    if isinstance(v, jdf.DF):
        return jdf.to_f64(v)
    return np.asarray(v, dtype=np.float64)


def _jax_matvec(plan, x):
    xd = plan.vec_in(x)
    vs = jax.tree.map(lambda _: P(plan.axis), xd)
    f = jax.jit(jax.shard_map(plan.local_matvec, mesh=plan.mesh,
                              in_specs=(plan.a_specs, vs), out_specs=vs, check_vma=False))
    return plan.vec_out(f(plan.a_arrays, xd))


def _rank_mesh(rank: int, size: int) -> tmesh.Mesh:
    """Rank `rank` of `size` without a group: enough to build a plan."""
    return tmesh.Mesh(axis="x", rank=rank, size=size, device=torch.device("cpu"),
                      group=None, transport="host")


def _spd(rng, n):
    Q = rng.normal(size=(n, n))
    A = Q @ Q.T + n * np.eye(n)
    return dense_to_csr_arrays(A) + ((n, n),), A


def _unsym(rng, n):
    (ip, ix, dv), shape = random_csr(rng, n, n, 0.08)
    A = sp.csr_matrix((dv, ix, ip), shape=shape)
    A = (A + sp.eye(n) * (np.abs(A).sum(axis=1).max() + 1.0)).tocsr()
    return (A.indptr, A.indices, A.data, shape), A


def _build_cases():
    """name -> (port case, JAX result, reference): every input seeded numpy."""
    jmesh = jd.make_mesh(NDEV)
    cases = {}
    rng = np.random.default_rng(1234)
    (ip, ix, dv), shape = random_csr(rng, 96, 96, 0.08)
    x = rng.normal(size=96)
    dense = sp.csr_matrix((dv, ix, ip), shape=shape)
    for dtype in ("f32", "f64", "df64"):
        jp = jd.DistSpmvPlan.build(ip, ix, dv, shape, jmesh, dtype=dtype)
        arrays = dict(data=np.asarray(jp.data), indices=np.asarray(jp.indices),
                      shape=shape, n_pad=jp.n_pad, dtype=dtype)
        cases[f"matvec_dist_{dtype}"] = (
            {"plan": "dist", "op": "matvec", "arrays": arrays, "x": x},
            _jax_matvec(jp, x), dense @ x)
    stencil = seven_point_csr(8, 8, 8)
    (rip, rix, rdv), rshape = random_csr(np.random.default_rng(5), 96, 96, 0.08)
    for name, (a, b, c, s) in (("stencil", stencil), ("random", (rip, rix, rdv, rshape))):
        xs = np.random.default_rng(0).normal(size=s[0])
        jp = jh.HaloSpmvPlan.build(a, b, c, s, jmesh, dtype="f64")
        cases[f"matvec_halo_{name}"] = (
            {"plan": "halo", "op": "matvec", "csr": (a, b, c, s), "dtype": "f64", "x": xs},
            np.asarray(jh.halo_matvec(jp, jp.vec_in(xs)), dtype=np.float64)[: s[0]],
            sp.csr_matrix((c, b, a), shape=s) @ xs)
    cls = CLASSES["S"]
    sip, six, sdv, _ = make_cg_matrix("S")
    for dtype in ("f64", "df64"):
        jp = jd.DistSpmvPlan.build(sip, six, sdv, (cls.na, cls.na), jmesh, dtype=dtype)
        z, r, _ = jd.dist_npb_power_method(jp, jp.vec_in(np.ones(cls.na)), cls.shift,
                                           cls.niter)
        cases[f"power_{dtype}"] = (
            {"plan": "dist", "op": "power", "csr": (sip, six, sdv, (cls.na, cls.na)),
             "dtype": dtype, "shift": cls.shift, "niter": cls.niter},
            {"zetas": _jf64(z), "rnorms": _jf64(r)}, cls.zeta_verify)
    csr, A = _spd(np.random.default_rng(7), 64)
    b = np.random.default_rng(8).normal(size=64)
    jp = jd.DistSpmvPlan.build(*csr, jmesh, dtype="f64")
    jx, jit, _ = jd.dist_cg_solve(jp, jp.vec_in(b), maxit=200, rtol=1e-10)
    cases["cg_spd_f64"] = (
        {"plan": "dist", "op": "cg", "csr": csr, "dtype": "f64", "b": b, "maxit": 200,
         "rtol": 1e-10},
        {"x": jp.vec_out(jx), "it": int(jit)}, np.linalg.solve(A, b))
    csr, A = _unsym(np.random.default_rng(11), 80)
    b = np.random.default_rng(12).normal(size=80)
    for dtype in ("f64", "df64"):
        jp = jd.DistSpmvPlan.build(*csr, jmesh, dtype=dtype)
        jpt = jd.dist_transposed_plan(*csr, jmesh, dtype=dtype)
        jx, jits, jhist, _ = jd.dist_bicg_solve(jp, jpt, jp.vec_in(b), maxit=200,
                                                rtol=1e-10)
        cases[f"bicg_{dtype}"] = (
            {"plan": "dist", "op": "bicg", "csr": csr, "dtype": dtype, "b": b,
             "maxit": 200, "rtol": 1e-10},
            {"x": jp.vec_out(jx), "its": int(jits), "hist": np.asarray(jhist)},
            sp.linalg.spsolve(A.tocsc(), b))
    return cases


# the cases are built in a fixture, not at import: every xdist worker imports
# every test module
MATVECS = ["matvec_dist_f32", "matvec_dist_f64", "matvec_dist_df64",
           "matvec_halo_stencil", "matvec_halo_random"]
NAMES = MATVECS + ["power_f64", "power_df64", "cg_spd_f64", "bicg_f64", "bicg_df64"]


@pytest.fixture(scope="module")
def cases():
    built = _build_cases()
    assert sorted(built) == sorted(NAMES)
    return built


@pytest.fixture(scope="module")
def ranks(cases):
    """Every case on a Gloo group of NDEV CPU ranks, spawned once."""
    return launch.run_spmd(R.run_cases, NDEV, {k: v[0] for k, v in cases.items()},
                           backend="gloo", device="cpu")


WORLD_OF_ONE_STEPS = 3  # outer steps of class S: the identity needs no more


@pytest.fixture(scope="module")
def world_of_one(cases):
    one = {k: dict(cases[k][0], niter=WORLD_OF_ONE_STEPS) for k in ("power_f64", "power_df64")}
    return launch.run_spmd(R.run_cases, 1, one, backend="gloo", device="cpu")[0]


@pytest.mark.parametrize("name", MATVECS)
def test_matvec_matches_reference(cases, ranks, name):
    case, want, oracle = cases[name]
    dtype = case["dtype"] if "dtype" in case else case["arrays"]["dtype"]
    got = _f64(ranks[0][name])
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(got, oracle, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["f64", "df64"])
def test_npb_class_s_verifies_on_4_ranks(cases, ranks, dtype):
    got = ranks[0][f"power_{dtype}"]
    want, zeta_verify = cases[f"power_{dtype}"][1:]
    zetas = _f64(got["zetas"])
    assert abs(zetas[-1] - zeta_verify) / zeta_verify <= 1e-10
    np.testing.assert_allclose(zetas, want["zetas"], rtol=ZETA_HIST_RTOL, atol=0)
    np.testing.assert_allclose(_f64(got["rnorms"]), want["rnorms"], rtol=0,
                               atol=RNORM_HIST_ATOL)


def test_cg_spd(cases, ranks):
    got = ranks[0]["cg_spd_f64"]
    want, x_ref = cases["cg_spd_f64"][1:]
    assert 0 < got["it"] < 200 and abs(got["it"] - want["it"]) <= 1
    np.testing.assert_allclose(got["x"], want["x"], rtol=SOLVE_RTOL, atol=SOLVE_RTOL)
    np.testing.assert_allclose(got["x"], x_ref, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("dtype", ["f64", "df64"])
def test_bicg_with_staged_transpose(cases, ranks, dtype):
    got = ranks[0][f"bicg_{dtype}"]
    want, x_ref = cases[f"bicg_{dtype}"][1:]
    assert got["its"] > 0 and got["its"] == want["its"]
    np.testing.assert_allclose(got["x"], want["x"], rtol=SOLVE_RTOL, atol=SOLVE_RTOL)
    np.testing.assert_allclose(got["x"], x_ref, rtol=1e-6, atol=1e-8)
    k = got["its"]
    np.testing.assert_allclose(got["hist"][:k], want["hist"][:k], rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_every_rank_returns_the_same_bits(ranks, name):
    assert launch.same_bits([r[name] for r in ranks])
    assert [r["_mesh"]["rank"] for r in ranks] == list(range(NDEV))
    assert {r["_mesh"]["transport"] for r in ranks} == {"host"}


@pytest.mark.parametrize("dtype", ["f64", "df64"])
def test_world_of_one_is_the_single_process_run(world_of_one, dtype):
    """One rank: the dot's gather and sum are the identity, the matvec the
    registry's ELL kernel on the same arrays: npb_cg.run's bits."""
    res = npb_cg.run("S", dtype=dtype, kernel="xla_ell_df" if dtype == "df64" else "xla_ell",
                     niter=WORLD_OF_ONE_STEPS, device="cpu")
    got = _f64(world_of_one[f"power_{dtype}"]["zetas"])
    np.testing.assert_array_equal(got, res.zeta_history)


@pytest.mark.parametrize("ndev", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["f32", "df64"])
def test_row_block_arrays_bit_identical(ndev, dtype):
    (ip, ix, dv), shape = random_csr(np.random.default_rng(3), 90, 90, 0.1)
    jp = jd.DistSpmvPlan.build(ip, ix, dv, shape, jd.make_mesh(ndev), dtype=dtype)
    plans = [td.DistSpmvPlan.build(ip, ix, dv, shape, _rank_mesh(r, ndev), dtype=dtype)
             for r in range(ndev)]
    np.testing.assert_array_equal(np.stack([p.data.numpy() for p in plans]),
                                  np.asarray(jp.data))
    np.testing.assert_array_equal(np.stack([p.indices.numpy() for p in plans]),
                                  np.asarray(jp.indices))
    assert (plans[0].n_pad, plans[0].rps) == (jp.n_pad, jp.n_pad // ndev)


@pytest.mark.parametrize("ndev", [2, 4, 8])
@pytest.mark.parametrize("matrix", ["stencil", "random"])
def test_halo_tables_bit_identical(ndev, matrix):
    if matrix == "stencil":
        ip, ix, dv, shape = seven_point_csr(8, 8, 8)
    else:
        (ip, ix, dv), shape = random_csr(np.random.default_rng(5), 96, 96, 0.08)
    jp = jh.HaloSpmvPlan.build(ip, ix, dv, shape, jd.make_mesh(ndev), dtype="f64")
    rps, n_pad, ev, new_ec, dist_ks, halos, send_tbls = th.halo_host(
        ip, ix, dv, shape, ndev, "f64")
    assert (dist_ks, halos, rps, n_pad) == (jp.dist_ks, jp.halos, jp.rps, jp.n_pad)
    np.testing.assert_array_equal(ev, np.asarray(jp.data))
    np.testing.assert_array_equal(new_ec, np.asarray(jp.indices))
    assert len(send_tbls) == len(jp.send_tbls)
    for t, u in zip(send_tbls, jp.send_tbls):
        np.testing.assert_array_equal(t, np.asarray(u))
    if matrix == "stencil" and ndev == 8:  # only the two z-neighbours exchange
        assert dist_ks == (1, 7) and max(halos) < shape[0] // 4
    for r in range(ndev):
        p = th.HaloSpmvPlan.build(ip, ix, dv, shape, _rank_mesh(r, ndev), dtype="f64")
        np.testing.assert_array_equal(p.indices.numpy(), new_ec[r])
        assert [t.tolist() for t in p.send_tbls] == [t[r].tolist() for t in send_tbls]


def test_make_mesh_nccl_refuses_more_ranks_than_cards():
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=rf"{cards + 1} rank\(s\) on {cards} CUDA"):
        tmesh.make_mesh(cards + 1, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match=rf"{cards + 2} rank\(s\) on {cards} CUDA"):
        launch.run_spmd(R.run_cases, cards + 2, {}, backend="nccl", device="cpu")


def test_a_failed_rank_fails_the_run():
    """Rank 1 raises while rank 0 waits in a collective for it: the run
    raises with rank 1's traceback instead of hanging."""
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 failed(.|\n)*rank 1 gives up"):
        launch.run_spmd(R.fail_on_rank, 2, 1, backend="gloo", device="cpu", timeout_s=60)


def test_dryrun_multichip_two_ranks():
    res = dryrun_multichip(2, "cpu")
    assert launch.same_bits(res)
    r = res[0]
    assert (r["transport"], r["size"], r["device"]) == ("host", 2, "cpu")
    assert np.isfinite(r["zetas"]).all() and r["zetas"].shape == (2,)
    for name in ("routed", "halo_routed", "routed_hier"):
        np.testing.assert_allclose(r[name], r["cg"], rtol=1e-4, atol=1e-4)
    ip, ix, dv, shape = seven_point_csr(8, 8, 4)
    np.testing.assert_allclose(r["halo"], sp.csr_matrix((dv, ix, ip), shape=shape) @
                               np.ones(shape[0]), rtol=TOL["f32"], atol=TOL["f32"])
