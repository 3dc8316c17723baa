"""The port's distributed layer (``blockcg_tpu_torch/parallel``) against the
reference's (``blockcg_tpu/parallel``) on the same numpy inputs.

The port runs in D processes of a gloo group on the CPU (the rank side is
``tests/torch_dist_ranks.py``, which imports no JAX): one pool of ranks per
D, started on first use through a FileStore under ``tmp_path`` and reused
by every case of that D. The reference runs on the fake CPU devices of
``tests/conftest.py`` (``row_mesh(D)``), its kernels in interpret mode where
its apply reaches them.

Tolerances: partition plans bitwise; f32 applies to 1e-6 (max relative
error; Grams relative Frobenius); f64 solves with the reference's iteration
count and X to 1e-9 (max relative error), the same bits on every rank;
``solve_refined_dist`` to a true f64 relres <= 1e-10; the halo slab adds
(rows 20 and 21) against the reference's interpret kernel and a numpy loop
to 1e-6 in f32.
"""

import importlib
import multiprocessing as mp

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as JP

import torch_dist_ranks as ranks
from blockcg_tpu import parallel as jpar
from blockcg_tpu.operators.cheb import estimate_spectrum as j_estimate_spectrum
from blockcg_tpu.ops import const_block_stencil as jcbs
from blockcg_tpu.parallel.api import shard_map
from blockcg_tpu.problems import (
    dirac_bdia as j_dirac_bdia,
    dirac_cbdia as j_dirac_cbdia,
    dirac_gauged_cbdia as j_dirac_gauged_cbdia,
    laplacian_dia as j_laplacian_dia,
)
from blockcg_tpu.solvers.pbcg import jacobi_preconditioner as j_jacobi
from blockcg_tpu_torch import parallel as tpar
from blockcg_tpu_torch.ops import const_block_stencil as cbs
from blockcg_tpu_torch.problems import laplacian_scipy

jeo = importlib.import_module("blockcg_tpu.problems.dirac_eo")

JBUILD = {
    "laplacian": lambda dt: j_laplacian_dia((16, 16, 16), dtype=dt),
    "cbdia": lambda dt: j_dirac_cbdia(8, dtype=dt),
    "cbdia_open": lambda dt: j_dirac_cbdia(8, bc="open", dtype=dt),
    "gauged": lambda dt: j_dirac_gauged_cbdia(8, dtype=dt),
    "bdia": lambda dt: j_dirac_bdia(8, dtype=dt),
    "bdia_open": lambda dt: j_dirac_bdia(8, bc="open", dtype=dt),
    "eo": lambda dt: jeo.dirac_eo(8, dtype=dt),
    "eo_gauged": lambda dt: jeo.dirac_gauged_eo(8, dtype=dt),
}
MAX_RANKS = 10  # rank processes alive at once: the pools of D = 1..4


class RankPool:
    """D spawned ranks serving ``torch_dist_ranks.CASES``."""

    def __init__(self, D: int, store: str):
        ctx = mp.get_context("spawn")
        self.D = D
        self.tasks = [ctx.Queue() for _ in range(D)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=ranks.serve, daemon=True,
                                  args=(r, D, store, self.tasks[r], self.results))
                      for r in range(D)]
        for p in self.procs:
            p.start()

    def run(self, name: str, **kwargs) -> list:
        """Every rank's result of one case, by rank."""
        for q in self.tasks:
            q.put((name, kwargs))
        got = {}
        for _ in range(self.D):
            rank, status, out = self.results.get(timeout=300)
            got[rank] = (status, out)
        errors = [out for status, out in got.values() if status != "ok"]
        if errors:
            raise AssertionError(f"a rank of D={self.D} failed:\n{errors[0]}")
        return [got[r][1] for r in range(self.D)]

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    root = tmp_path_factory.mktemp("gloo")
    live: dict[int, RankPool] = {}
    made = []

    def get(D: int) -> RankPool:
        if D not in live:
            while live and sum(live) + D > MAX_RANKS:
                live.pop(next(iter(live))).close()
            made.append(D)
            live[D] = RankPool(D, str(root / f"store{len(made)}"))
        return live[D]

    yield get
    for pool in live.values():
        pool.close()


def _relmax(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def _relfro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _port_op(kind, dtype="float64"):
    return ranks.operator(kind, dtype)


def _ref_partition(kind, jop, D):
    if kind.startswith("laplacian"):
        return jpar.partition_dia(jop, D)
    if kind.startswith("bdia"):
        return jpar.partition_bdia(jop, D)
    if kind.startswith("eo"):
        return jpar.partition_dirac_eo(jop, D)
    return jpar.partition_cbdia(jop, D)


# ------------------------------------------------------------ plans --------


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_dia_plan_is_the_reference(D):
    jd = jpar.partition_dia(JBUILD["laplacian"](jnp.float64), D)
    pd = tpar.partition_dia(_port_op("laplacian"), D)
    for name in ("diags_int", "diags_bl", "diags_br"):
        np.testing.assert_array_equal(getattr(pd, name), np.asarray(getattr(jd, name)))
    assert (pd.offsets, pd.bw, pd.pad_sites) == (jd.offsets, jd.bw, jd.pad_sites)
    assert pd.pad_sites == (2 if D == 3 else 0)  # 4096 + 2 = 3 * 1366


@pytest.mark.parametrize("kind,D", [("bdia", 1), ("bdia", 2), ("bdia", 4), ("bdia_open", 3),
                                    ("bdia_open", 4)])
def test_bdia_plan_is_the_reference(kind, D):
    jd = jpar.partition_bdia(JBUILD[kind](jnp.float64), D)
    pd = tpar.partition_bdia(_port_op(kind), D)
    for name in ("blocks_int", "blocks_bl", "blocks_br"):
        np.testing.assert_array_equal(getattr(pd, name), np.asarray(getattr(jd, name)))
    assert (pd.offsets, pd.bw, pd.pad_sites) == (jd.offsets, jd.bw, jd.pad_sites)


def _same_cbdia_plan(pd, jd):
    loc = jd.local
    assert pd.crossings == jd.crossings and (pd.bw, pd.g) == (jd.bw, jd.g)
    assert pd.hops == loc.hops and pd.offsets == loc.offsets
    assert pd.mask_slot == loc.mask_slot and pd.slabs == loc.slabs
    np.testing.assert_array_equal(pd.masks, np.asarray(loc.masks))
    assert len(pd.cross_vals) == len(jd.cross_vals)
    for pv, jv in zip(pd.cross_vals, jd.cross_vals):
        assert (pv is None) == (jv is None)
        if jv is not None:
            assert pv.dtype == np.asarray(jv).dtype
            np.testing.assert_array_equal(pv, np.asarray(jv))


@pytest.mark.parametrize("kind,D", [("cbdia", 1), ("cbdia", 2), ("cbdia", 4), ("cbdia", 8),
                                    ("cbdia_open", 2), ("gauged", 1), ("gauged", 4)])
def test_cbdia_plan_is_the_reference(kind, D):
    jd = jpar.partition_cbdia(JBUILD[kind](jnp.float32), D)
    pd = tpar.partition_cbdia(_port_op(kind, "float32"), D)
    _same_cbdia_plan(pd, jd)
    if D == 1:  # at D = 1 the t-hops still cross: their wraps go round the ring
        assert sorted(c[1] for c in pd.crossings) == [-512, 512]


@pytest.mark.parametrize("kind,D", [("eo", 1), ("eo", 2), ("eo_gauged", 4)])
def test_dirac_eo_plan_is_the_reference(kind, D):
    jd = jpar.partition_dirac_eo(JBUILD[kind](jnp.float64), D)
    pd = tpar.partition_dirac_eo(_port_op(kind), D)
    _same_cbdia_plan(pd.hop_eo, jd.hop_eo)
    _same_cbdia_plan(pd.hop_oe, jd.hop_oe)
    assert pd.c == jd.c


def test_padding_refuses_periodic_wraps():
    with pytest.raises(ValueError, match="wrap"):
        tpar.partition_bdia(_port_op("bdia"), 3)
    with pytest.raises(ValueError, match="[Vv]alid D"):
        tpar.partition_cbdia(_port_op("cbdia", "float32"), 6)
    with pytest.raises(ValueError, match="process group"):
        tpar.partition_dia(_port_op("laplacian"), 2).shard(0, None, "cpu")


def test_dist_order_is_the_reference():
    X = np.random.default_rng(3).standard_normal((4 * 16, 2))
    Xd = tpar.to_dist_order(X, 4, 4)
    np.testing.assert_array_equal(Xd, jpar.to_dist_order(X, 4, 4))
    np.testing.assert_array_equal(tpar.from_dist_order(Xd, 4, 4), X)


# ------------------------------------------------ rows 20 and 21 -----------


def _slab_from_loop(hop, g, nblocks, dst_base, src_base, Src, Ym, vals):
    """Row 20's contract written as loops over sites, in f64."""
    hop = np.asarray(hop, np.float64)
    bs = hop.shape[0]
    k = Ym.shape[0] // bs
    Y = np.asarray(Ym, np.float64).copy()
    for j in range(nblocks * g):
        d, s = dst_base * g + j, src_base * g + j
        v = 1.0 if vals is None else float(vals[0, j])
        for a in range(bs):
            for i in range(k):
                Y[a * k + i, d] += v * sum(hop[a, b] * Src[b * k + i, s] for b in range(bs))
    return Y


@pytest.mark.parametrize("with_gram", [False, True])
@pytest.mark.parametrize("with_vals", [False, True])
def test_slab_from_plain_matches_reference(with_gram, with_vals):
    """Row 20's plain version against the reference's Pallas kernel in
    interpret mode and against the loop, on a dirac_cbdia hop: 3 blocks of
    g = 256 from block 1 of a 4-block halo into blocks 5..7 of 8."""
    rng = np.random.default_rng(40)
    hop = _port_op("cbdia", "float32").hops[0]
    bs, k, g, nb, dst_base, src_base = 4, 3, 256, 3, 5, 1
    m = bs * k
    Src = rng.standard_normal((m, 4 * g)).astype(np.float32)
    Ym = rng.standard_normal((m, 8 * g)).astype(np.float32)
    Xm = rng.standard_normal((m, 8 * g)).astype(np.float32)
    vals = (rng.choice([-1.0, 1.0], (1, nb * g)).astype(np.float32) if with_vals else None)
    Y = torch.from_numpy(Ym.copy())
    out = cbs.slab_m_accumulate_from(
        hop, g, nb, dst_base, src_base, torch.from_numpy(Src), Y, torch.from_numpy(Xm),
        None if vals is None else torch.from_numpy(vals), with_gram=with_gram)
    jout = jcbs.slab_m_accumulate_from(
        hop, g, nb, dst_base, src_base, jnp.asarray(Src), jnp.asarray(Ym), jnp.asarray(Xm),
        None if vals is None else jnp.asarray(vals), with_gram=with_gram, interpret=True)
    got, jgot = (out, jout) if with_gram else ((out, None), (jout, None))
    assert got[0] is Y  # in place
    assert _relmax(got[0], jgot[0]) < 1e-6
    loop = _slab_from_loop(hop, g, nb, dst_base, src_base, Src, Ym, vals)
    assert _relmax(got[0], loop) < 1e-6
    if with_gram:
        cols = slice(dst_base * g, (dst_base + nb) * g)
        want = Xm[:, cols].astype(np.float64) @ (loop - Ym)[:, cols].T
        assert _relfro(got[1], jgot[1]) < 1e-6 and _relfro(got[1], want) < 1e-6


@pytest.mark.parametrize("k", [1, 3])
def test_slab_view_from_plain_is_the_merged_form(k):
    """Row 21 (its reference body is broken) on the (k, bs, ns) view: the
    merged form of the same fields through row 20, and the loop."""
    rng = np.random.default_rng(41)
    hop = _port_op("cbdia").hops[5]
    bs, g, nb = 4, 256, 2
    Src = rng.standard_normal((k, bs, 2 * g))
    Yv = rng.standard_normal((k, bs, 4 * g))

    def merged(F):
        return F.transpose(1, 0, 2).reshape(bs * k, -1).copy()
    Y = torch.from_numpy(Yv.copy())
    got = cbs.slab_block_accumulate_from(hop, g, nb, 2, 0, torch.from_numpy(Src), Y)
    assert got is Y
    Ym = torch.from_numpy(merged(Yv))
    cbs.slab_m_accumulate_from(hop, g, nb, 2, 0, torch.from_numpy(merged(Src)), Ym)
    assert _relmax(merged(got.numpy()), Ym) < 1e-12
    loop = _slab_from_loop(hop, g, nb, 2, 0, merged(Src), merged(Yv), None)
    assert _relmax(merged(got.numpy()), loop) < 1e-12
    if k == 1:  # one right-hand side: the two layouts are the same memory
        np.testing.assert_array_equal(got.numpy().reshape(bs, -1), Ym.numpy())


def test_slab_from_refuses_bad_geometry():
    hop = torch.eye(4)
    Y, Src = torch.zeros((8, 1024)), torch.zeros((8, 512))
    with pytest.raises(ValueError, match="blocks"):
        cbs.slab_m_accumulate_from(hop, 256, 2, 3, 0, Src, Y)  # past Y's 4 blocks
    with pytest.raises(ValueError, match="blocks"):
        cbs.slab_m_accumulate_from(hop, 256, 2, 0, 1, Src, Y)  # past the halo's 2
    with pytest.raises(ValueError, match="vals"):
        cbs.slab_m_accumulate_from(hop, 256, 2, 0, 0, Src, Y, vals=torch.ones((1, 256)))
    with pytest.raises(ValueError, match="local field"):
        cbs.slab_m_accumulate_from(hop, 256, 2, 0, 0, Src, Y, with_gram=True)


# --------------------------------------------------- halos and applies ----


@pytest.mark.parametrize("D", [1, 2, 3])
def test_ring_halos(pools, D):
    """Each rank gets its left neighbour's last bw columns and its right
    neighbour's first bw (toroidal; its own at D = 1), on a 3-D field."""
    nl, bw = 10, 4
    X = np.random.default_rng(D).standard_normal((2, 3, D * nl))
    shards = np.split(X, D, axis=-1)
    for r, (hl, hr) in enumerate(pools(D).run("halos", X=X, bw=bw)):
        np.testing.assert_array_equal(hl, shards[(r - 1) % D][..., -bw:])
        np.testing.assert_array_equal(hr, shards[(r + 1) % D][..., :bw])


def _ref_apply(kind, D, Xt, gram):
    """The reference's distributed apply (and psum'd fused Gram, its
    kernels in interpret mode) of a global flat f32 (k, n) field."""
    jop = JBUILD[kind](jnp.float32)
    jdop = _ref_partition(kind, jop, D)
    mesh = jpar.row_mesh(D)
    k = Xt.shape[0]
    pad = getattr(jdop, "pad_sites", 0)
    if kind.startswith("laplacian"):
        spec, field = JP(None, "rows"), np.pad(Xt, ((0, 0), (0, pad)))
    elif kind.startswith("bdia"):
        spec = JP(None, None, "rows")
        field = np.pad(Xt.reshape(k, jop.bs, -1), ((0, 0), (0, 0), (0, pad)))
    else:
        spec, field = JP(None, "rows"), np.asarray(jop.to_internal(jnp.asarray(Xt)))

    def body(o, x):
        if not gram:
            return o.matmat_t(x)
        y, gl = o.matmat_gram_t(x, interpret=True)
        return y, lax.psum(gl, "rows")
    fn = shard_map(body, mesh=mesh, in_specs=(jdop.in_specs(), spec),
                   out_specs=(spec, JP()) if gram else spec, check_vma=False)
    out = jax.jit(fn)(jdop, jax.device_put(jnp.asarray(field), NamedSharding(mesh, spec)))
    Y, G = (out if gram else (out, None))
    Y = np.asarray(Y)
    if kind.startswith("laplacian"):
        Y = Y[:, :Xt.shape[1]]
    elif kind.startswith("bdia"):
        Y = Y[:, :, :Y.shape[2] - pad].reshape(k, -1)
    else:
        Y = np.asarray(jop.from_internal(jnp.asarray(Y)))
    return Y, (None if G is None else np.asarray(G))


@pytest.mark.parametrize("kind,D,k,gram", [
    ("laplacian", 1, 3, False), ("laplacian", 2, 3, False), ("laplacian", 3, 3, False),
    ("laplacian", 4, 3, False), ("bdia", 1, 2, False), ("bdia", 2, 2, False),
    ("bdia", 4, 2, False), ("bdia_open", 3, 2, False), ("cbdia", 1, 2, False),
    ("cbdia", 2, 2, True), ("cbdia", 4, 1, False), ("cbdia", 4, 2, True),
    ("cbdia_open", 2, 2, False), ("gauged", 1, 1, False), ("gauged", 2, 2, True),
])
def test_dist_apply_matches_reference(pools, kind, D, k, gram):
    """f32 applies (the fused Gram where the reference has one) against the
    reference's on its mesh of D devices; at k = 1 the const-hop shard's
    unit crossings take row 21, gauged ones row 20."""
    n = _port_op(kind, "float32").shape[0]
    Xt = np.random.default_rng(50 + D).standard_normal((k, n)).astype(np.float32)
    out = pools(D).run("apply", kind=kind, dtype="float32", Xt=Xt, gram=gram)
    Y, G = out[0]
    assert all(np.array_equal(Y, o[0]) for o in out[1:])
    want, wantG = _ref_apply(kind, D, Xt, gram)
    assert _relmax(Y, want) < 1e-6
    if gram:
        assert _relfro(G, wantG) < 1e-6


# ------------------------------------------------------------ solves ------


def _rhs(kind, k, seed):
    op = _port_op(kind)
    n = op.n if kind.startswith("eo") else op.shape[0]
    return np.random.default_rng(seed).standard_normal((n, k))


def _ref_solve(kind, D, solver, B, kw):
    jop = JBUILD[kind](jnp.float64)
    mesh = jpar.row_mesh(D)
    Bj = jnp.asarray(B)
    if solver == "eo":
        return jeo.solve_dirac_eo_dist(jop, Bj, mesh, **kw)
    jdop = _ref_partition(kind, jop, D)
    if solver == "sbcgrq":
        return jpar.solve_sbcgrq_dist(jdop, Bj, mesh, **kw)
    if solver == "bcg":
        return jpar.solve_bcg_dist(jdop, Bj, mesh, **kw)
    if solver == "cg":
        return jpar.solve_cg_dist(jdop, Bj, mesh, **kw)
    if solver == "shifted":
        kw = dict(kw)
        return jpar.solve_shifted_sbcgrq_dist(jdop, Bj, kw.pop("sigmas"), mesh, **kw)
    if solver == "psbcgrq":
        return jpar.solve_psbcgrq_dist(jdop, Bj, j_jacobi(jop), mesh, **kw)
    if solver == "cheb":
        return jpar.solve_sbcgrq_cheb_dist(jdop, Bj, mesh, **kw)
    raise ValueError(solver)


SOLVES = [
    ("sbcgrq", "laplacian", 1), ("sbcgrq", "laplacian", 3), ("sbcgrq", "laplacian", 4),
    ("bcg", "laplacian", 2), ("cg", "laplacian", 4), ("shifted", "laplacian", 2),
    ("psbcgrq", "laplacian", 4), ("cheb", "laplacian", 4), ("sbcgrq", "cbdia", 1),
    ("sbcgrq", "cbdia", 2), ("sbcgrq", "gauged", 4), ("shifted", "cbdia", 2),
    ("sbcgrq", "bdia", 2), ("sbcgrq", "bdia_open", 3), ("eo", "eo", 1), ("eo", "eo", 2),
    ("eo", "eo_gauged", 4),
]


def _solve_kwargs(solver, kind):
    kw = {"tol": 1e-9, "max_iter": 400}
    if solver == "shifted":
        kw["sigmas"] = [0.0, 0.6, 2.0]
    if solver == "cheb":
        kw["spectrum"] = tuple(float(x) for x in
                               j_estimate_spectrum(JBUILD[kind](jnp.float64)))
        kw["degree"] = 4
    return kw


def _check_solve(pools, solver, kind, D, seed=60):
    k = 1 if solver == "cg" else 3
    B = _rhs(kind, k, seed)
    if solver == "cg":
        B = B[:, 0]
    kw = _solve_kwargs(solver, kind)
    out = pools(D).run("solve", kind=kind, dtype="float64", solver=solver, B=B, kwargs=kw)
    X, it, _ = out[0]
    assert all(np.array_equal(X, o[0]) and it == o[1] for o in out[1:])
    Xj, info = _ref_solve(kind, D, solver, B, kw)
    assert it == int(info.iterations)
    assert _relmax(X, np.asarray(Xj)) < 1e-9


@pytest.mark.parametrize("solver,kind,D", SOLVES)
def test_dist_solve_matches_reference(pools, solver, kind, D):
    """f64 distributed solves: the reference's iteration count on its mesh
    of D devices, X to 1e-9, the same X on every rank."""
    _check_solve(pools, solver, kind, D)


def test_refined_dist_reaches_1e10(pools):
    """The north-star composition row-partitioned: f32 inner solves on the
    shards, f64 outer cycles on the f64 shard, to a true relres <= 1e-10."""
    B = _rhs("laplacian", 4, 70)
    out = pools(2).run("solve", kind="laplacian", dtype="float32", solver="refined", B=B,
                       kwargs={"tol": 1e-10, "inner_tol": 1e-5})
    X, cycles, relres = out[0]
    B = B.astype(np.float32).astype(np.float64)  # the system solved: B in f32
    a = laplacian_scipy((16, 16, 16))
    res = np.linalg.norm(a @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-10 and relres.max() <= 1e-10 and 2 <= cycles <= 4


def test_dist_rejects_complex_rhs(pools):
    B = _rhs("laplacian", 2, 71) * (1 + 1j)
    assert pools(1).run("raises", kind="laplacian", dtype="float64", B=B) == \
        ["NotImplementedError"]


def test_dist_bf16_fields(pools):
    """bf16 fields (the plain versions on the CPU): f32 Grams on the wire, a
    bf16-limited true residual (the reference's test_distributed.py bound)."""
    B = np.random.default_rng(21).standard_normal((24 * 24, 4))
    out = pools(4).run("solve", kind="laplacian2d", dtype="bfloat16", solver="sbcgrq",
                       B=B, kwargs={"tol": 2e-2, "max_iter": 400})
    X = out[0][0]
    Bb = torch.from_numpy(B).to(torch.bfloat16).double().numpy()
    a = laplacian_scipy((24, 24))
    res = np.linalg.norm(a @ X - Bb, axis=0) / np.linalg.norm(Bb, axis=0)
    assert res.max() <= 8e-2


def test_dist_solve_at_d8(pools):
    """Eight ranks (the reference's fake mesh size): SBCGrQ on the
    Laplacian, shards of 512 rows."""
    _check_solve(pools, "sbcgrq", "laplacian", 8, seed=80)


def test_shards_default_to_the_card():
    """Every plan puts its shard on the card unless the caller names a
    device, as the builders do."""
    import inspect

    for plan in (tpar.DIAPartition, tpar.BlockDIAPartition, tpar.ConstBlockDIAPartition,
                 tpar.DiracEOPartition):
        assert inspect.signature(plan.shard).parameters["device"].default == "cuda"
