"""The port's per-shard routing plans (lilac_tpu_torch.parallel.dist_routed:
DistRoutedPlan, DistRoutedHierPlan, HaloRoutedPlan) against the JAX
package's lilac_tpu.parallel.dist_routed.

As in tests/test_torch_dist.py, the port's ranks run on a Gloo group of 4
CPU processes spawned once for this module (tests/torch_dist_ranks.py),
and the JAX side runs in this process on make_mesh(4). The kernels run
through their plain versions: K1 (routed_apply_plain) for DistRoutedPlan
and HaloRoutedPlan, the per-net hierarchical passes K3u-K6u for
DistRoutedHierPlan.

* Host tables bit for bit at 2, 4 and 8 ranks: the common chunk schedule,
  the slot packing (base, vals, rank, chunks), the single-table plans'
  packed masks with their (kinds, dists), and the hierarchical plans'
  per-net pass descriptors and masks at bl = 128 and the JAX package's
  gmax.
* Matvecs within tests/test_dist.py's tolerances (f32 3e-5, df64 5e-13) of
  the JAX package: of its routed plan where that runs in a few seconds
  under Pallas' interpreter, else of its DistSpmvPlan on the same matrix
  (the routing moves words only, so both compute the same sums), and of a
  scipy product.
* df64 CG through each routed family ends within 1e-8 relative of a
  direct solve (the JAX tests' bound) and of the JAX package's DistSpmvPlan
  CG, and every rank returns the same bits.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import PartitionSpec as P

from lilac_tpu.formats.convert import coo_to_csr_arrays
from lilac_tpu.generate.stencil import seven_point_csr
from lilac_tpu.kernels import routed as jrd
from lilac_tpu.parallel import dist as jd
from lilac_tpu.parallel import dist_routed as jdr
from lilac_tpu_torch.parallel import dist_routed as tdr
from lilac_tpu_torch.parallel import launch, mesh as tmesh
from tests import torch_dist_ranks as R

torch.set_num_threads(1)

NDEV = 4
TOL = {"f32": 3e-5, "df64": 5e-13}  # tests/test_dist.py:52
CG_TOL = 1e-8


def _f64(v) -> np.ndarray:
    if isinstance(v, tuple):
        return v[0].astype(np.float64) + v[1].astype(np.float64)
    return np.asarray(v, dtype=np.float64)


def _jax_matvec(plan, x):
    xd = plan.vec_in(x)
    vs = jax.tree.map(lambda _: P(plan.axis), xd)
    f = jax.jit(jax.shard_map(plan.local_matvec, mesh=plan.mesh,
                              in_specs=(plan.a_specs, vs), out_specs=vs, check_vma=False))
    return plan.vec_out(f(plan.a_arrays, xd))


def _rank_mesh(rank: int, size: int) -> tmesh.Mesh:
    return tmesh.Mesh(axis="x", rank=rank, size=size, device=torch.device("cpu"),
                      group=None, transport="host")


def _uniform(rng, n=96, k=5):
    cols = np.stack([rng.choice(n, size=k, replace=False) for _ in range(n)])
    A = sp.csr_matrix((rng.normal(size=(n, k)).ravel(), cols.ravel(),
                       np.arange(0, n * k + 1, k)), shape=(n, n))
    return A.indptr, A.indices, A.data, A.shape


def _heavy(rng, n=128):
    rows, cols, vals = [], [], []
    for i in range(n):
        k = 40 if i % 17 == 0 else (1 + int(rng.integers(0, 4)))
        c = rng.choice(n, size=min(k, n), replace=False)
        rows.extend([i] * len(c))
        cols.extend(c.tolist())
        vals.extend(rng.normal(size=len(c)).tolist())
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    return A.indptr, A.indices, A.data, A.shape


def _spread(rng, n=1600):
    nnz_row = np.minimum(1 + rng.poisson(5.0, size=n), n)
    nnz_row[rng.choice(n, 5, replace=False)] = 90  # heavy tail
    rows = np.repeat(np.arange(n), nnz_row)
    ip, ix, dv = coo_to_csr_arrays(rows, rng.integers(0, n, size=len(rows)),
                                   rng.normal(size=len(rows)), (n, n))
    return ip, ix, dv, (n, n)


def _banded(n=512, bw=17):
    offs = np.arange(-(bw // 2), bw // 2 + 1)
    rows = np.repeat(np.arange(n), bw)
    cols = (rows.reshape(n, bw) + offs).clip(0, n - 1).ravel()
    vals = np.random.default_rng(7).normal(size=n * bw)
    ip, ix, dv = coo_to_csr_arrays(rows, cols, vals, (n, n))
    return ip, ix, dv, (n, n)


def _spd_sparse(rng, n=64, k=4):
    cols = np.stack([np.concatenate([[i], rng.choice(n, size=k - 1, replace=False)])
                     for i in range(n)])
    valsm = rng.normal(size=(n, k)) * 0.1
    valsm[:, 0] = 0.0
    B = sp.csr_matrix((valsm.ravel(), cols.ravel(), np.arange(0, n * k + 1, k)),
                      shape=(n, n))
    A = sp.csr_matrix((B + B.T) * 0.5 + sp.eye(n) * (k + 1.0))
    return A.indptr, A.indices, A.data, A.shape


def _scipy(csr):
    ip, ix, dv, shape = csr
    return sp.csr_matrix((dv, ix, ip), shape=shape)


def _build_cases():
    """name -> (port case, JAX result, scipy result)."""
    jmesh = jd.make_mesh(NDEV)
    cases = {}
    uni = _uniform(np.random.default_rng(1234))
    x = np.random.default_rng(1).normal(size=96)
    jp = jdr.DistRoutedPlan.build(*uni, jmesh, dtype="f32")
    arrays = dict(masks=np.asarray(jp.masks), vals=np.asarray(jp.vals), inv_perm=(
        None if jp.inv_perm is None else np.asarray(jp.inv_perm)), kinds=jp.kinds,
        dists=jp.dists, chunks=jp.chunks, shape=jp.shape, n_pad=jp.n_pad, m=jp.m,
        rps=jp.rps, dtype="f32")
    cases["matvec_routed_f32"] = ({"plan": "routed", "op": "matvec", "arrays": arrays,
                                   "x": x}, _jax_matvec(jp, x), _scipy(uni) @ x)
    jg = jd.DistSpmvPlan.build(*uni, jmesh, dtype="df64")
    cases["matvec_routed_df64"] = ({"plan": "routed", "op": "matvec", "csr": uni,
                                    "dtype": "df64", "x": x}, _jax_matvec(jg, x),
                                   _scipy(uni) @ x)
    heavy = _heavy(np.random.default_rng(2))
    xh = np.random.default_rng(3).normal(size=128)
    jg = jd.DistSpmvPlan.build(*heavy, jmesh, dtype="f32")
    cases["matvec_routed_heavy_f32"] = (
        {"plan": "routed", "op": "matvec", "csr": heavy, "dtype": "f32", "x": xh},
        _jax_matvec(jg, xh), _scipy(heavy) @ xh)
    spread = _spread(np.random.default_rng(4))
    xs = np.random.default_rng(5).normal(size=1600)
    jp = jdr.DistRoutedHierPlan.build(*spread, jmesh, dtype="f32", bl=128)
    assert jp.m > jp.bl  # outer (butterfly / window) passes engaged
    arrays = dict(flat_masks=[np.asarray(mk) for mk in jp.flat_masks],
                  net_meta=jp.net_meta, vals=np.asarray(jp.vals),
                  inv_perm=np.asarray(jp.inv_perm), chunks=jp.chunks, shape=jp.shape,
                  n_pad=jp.n_pad, m=jp.m, rps=jp.rps, bl=jp.bl, dtype="f32")
    jg = jd.DistSpmvPlan.build(*spread, jmesh, dtype="f32")
    cases["matvec_hier_f32"] = ({"plan": "hier", "op": "matvec", "arrays": arrays, "x": xs},
                                _jax_matvec(jg, xs), _scipy(spread) @ xs)
    for name, csr in (("stencil", seven_point_csr(8, 8, 8)), ("multichunk", _banded())):
        xb = np.random.default_rng(8).normal(size=csr[3][0])
        if name == "multichunk":  # the B > 1 regression, through the JAX routed plan
            jp = jdr.HaloRoutedPlan.build(*csr, jmesh, dtype="f32")
            assert len(jp.chunks) > 1  # B > 1 nets a shard
        else:
            jp = jd.DistSpmvPlan.build(*csr, jmesh, dtype="f32")
        cases[f"matvec_halo_routed_{name}_f32"] = (
            {"plan": "halo_routed", "op": "matvec", "csr": csr, "dtype": "f32", "x": xb},
            _jax_matvec(jp, xb)[: csr[3][0]], _scipy(csr) @ xb)
    for name, plan, csr, kw, maxit, rtol in (
            ("routed", "routed", _spd_sparse(np.random.default_rng(9)), {}, 80, 1e-12),
            ("halo_routed", "halo_routed", seven_point_csr(6, 6, 6), {}, 120, 1e-12),
            ("hier", "hier", _spd_sparse(np.random.default_rng(10), n=200), {"bl": 128}, 300,
             1e-11)):
        b = np.ones(csr[3][0])
        jg = jd.DistSpmvPlan.build(*csr, jmesh, dtype="df64")
        jx, _, _ = jd.dist_cg_solve(jg, jg.vec_in(b), maxit=maxit, rtol=rtol)
        cases[f"cg_{name}_df64"] = (
            {"plan": plan, "op": "cg", "csr": csr, "dtype": "df64", "kw": kw, "b": b,
             "maxit": maxit, "rtol": rtol},
            jg.vec_out(jx), sp.linalg.spsolve(_scipy(csr).tocsc(), b))
    return cases


MATVECS = ["matvec_routed_f32", "matvec_routed_df64", "matvec_routed_heavy_f32",
           "matvec_hier_f32", "matvec_halo_routed_stencil_f32",
           "matvec_halo_routed_multichunk_f32"]
CGS = ["cg_routed_df64", "cg_halo_routed_df64", "cg_hier_df64"]


@pytest.fixture(scope="module")
def cases():
    built = _build_cases()
    assert sorted(built) == sorted(MATVECS + CGS)
    return built


@pytest.fixture(scope="module")
def ranks(cases):
    return launch.run_spmd(R.run_cases, NDEV, {k: v[0] for k, v in cases.items()},
                           backend="gloo", device="cpu")


@pytest.mark.parametrize("name", MATVECS)
def test_matvec_matches_reference(cases, ranks, name):
    case, want, oracle = cases[name]
    tol = TOL["df64" if name.endswith("df64") else "f32"]
    got = _f64(ranks[0][name])
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", CGS)
def test_df64_cg_matches_direct_solve(cases, ranks, name):
    _, want, oracle = cases[name]
    got = ranks[0][name]
    assert 0 < got["it"] < cases[name][0]["maxit"]
    np.testing.assert_allclose(got["x"], oracle, rtol=CG_TOL, atol=CG_TOL)
    np.testing.assert_allclose(got["x"], want, rtol=CG_TOL, atol=CG_TOL)


@pytest.mark.parametrize("name", MATVECS + CGS)
def test_every_rank_returns_the_same_bits(ranks, name):
    assert launch.same_bits([r[name] for r in ranks])


@pytest.mark.parametrize("ndev", [2, 4, 8])
@pytest.mark.parametrize("matrix, dtype, m_floor, sort_rows", [
    ("heavy", "f32", 1024, "auto"), ("uniform", "df64", 1024, "auto"),
    ("spread", "f32", 256, True)])
def test_chunk_schedule_and_packing_bit_identical(ndev, matrix, dtype, m_floor, sort_rows):
    csr = {"heavy": _heavy(np.random.default_rng(2)),
           "uniform": _uniform(np.random.default_rng(1234)),
           "spread": _spread(np.random.default_rng(4))}[matrix]
    got = tdr._pack_shard_chunks(*csr, ndev, dtype=dtype, m_floor=m_floor,
                                 sort_rows=sort_rows)
    want = jdr._pack_shard_chunks(*csr, ndev, dtype=dtype, m_floor=m_floor,
                                  sort_rows=sort_rows)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k
    prof = np.random.default_rng(ndev).integers(0, 40, size=(ndev, 64))
    assert tdr._common_chunk_schedule(prof, 256) == jdr._common_chunk_schedule(prof, 256)


def _same_single_table(got_plans, jp):
    np.testing.assert_array_equal(np.stack([p.masks.numpy() for p in got_plans]),
                                  np.asarray(jp.masks))
    np.testing.assert_array_equal(np.stack([p.vals.numpy() for p in got_plans]),
                                  np.asarray(jp.vals))
    p = got_plans[0]
    assert (p.kinds, p.dists, p.chunks, p.m, p.rps, p.n_pad) == (
        jp.kinds, jp.dists, jp.chunks, jp.m, jp.rps, jp.n_pad)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_routed_masks_bit_identical(ndev):
    csr = _heavy(np.random.default_rng(2))
    jp = jdr.DistRoutedPlan.build(*csr, jd.make_mesh(ndev), dtype="f32")
    assert jp.inv_perm is not None  # the heavy tail forces the sorted layout
    plans = [tdr.DistRoutedPlan.build(*csr, _rank_mesh(r, ndev), dtype="f32")
             for r in range(ndev)]
    _same_single_table(plans, jp)
    np.testing.assert_array_equal(np.stack([p.inv_perm.numpy() for p in plans]),
                                  np.asarray(jp.inv_perm))


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_halo_routed_masks_bit_identical(ndev):
    csr = _banded()
    jp = jdr.HaloRoutedPlan.build(*csr, jd.make_mesh(ndev), dtype="df64")
    plans = [tdr.HaloRoutedPlan.build(*csr, _rank_mesh(r, ndev), dtype="df64")
             for r in range(ndev)]
    _same_single_table(plans, jp)
    assert (plans[0].dist_ks, plans[0].halos) == (jp.dist_ks, jp.halos)
    for r, p in enumerate(plans):
        for t, u in zip(p.send_tbls, jp.send_tbls):
            np.testing.assert_array_equal(t.numpy(), np.asarray(u)[r])


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_hier_pass_schedule_bit_identical(ndev):
    """Every net's pass descriptors and every pass's masks, all shards, at
    bl = 128 and the JAX package's gmax for one f32 plane."""
    csr = _spread(np.random.default_rng(4))
    bl = 128
    jp = jdr.DistRoutedHierPlan.build(*csr, jd.make_mesh(ndev), dtype="f32", bl=bl)
    pk = tdr._pack_shard_chunks(*csr, ndev, dtype="f32", m_floor=2 * bl, sort_rows=True)
    meta, flat = tdr.hier_nets_host(pk["base"], ndev, len(pk["chunks"]), pk["n_pad"],
                                    pk["m"], bl, jrd.hier_gmax(bl, 1))
    assert meta == jp.net_meta
    assert len(flat) == len(jp.flat_masks)
    for got, want in zip(flat, jp.flat_masks):
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))
    plan = tdr.DistRoutedHierPlan.build(*csr, _rank_mesh(ndev - 1, ndev), dtype="f32", bl=bl)
    assert plan.net_meta == jp.net_meta  # the port's gmax is the JAX package's at bl = 128
    got = [p[-1].numpy() for net in plan.nets for p in net]
    for g, w in zip(got, flat):
        np.testing.assert_array_equal(g, w[ndev - 1])
