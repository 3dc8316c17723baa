"""The port's problem builders, operator and checkpoints against the
reference package, on CPU tensors.

The band construction must be bitwise the reference's; an operator carried
across with ``DIAOperator.from_numpy`` must apply the same matrix (f64,
agreement to rounding, 1e-12 relative).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import torch

from blockcg_tpu.operators import DIAOperator as JDIAOperator
from blockcg_tpu.problems import laplacian as jlaplacian
from blockcg_tpu.problems import presets as jpresets
from blockcg_tpu.utils.checkpoint import load_checkpoint as jload
from blockcg_tpu.utils.checkpoint import save_checkpoint as jsave
from blockcg_tpu_torch import DIAOperator
from blockcg_tpu_torch.operators import assert_wrap_zero, astype
from blockcg_tpu_torch.problems import laplacian, presets
from blockcg_tpu_torch.utils import load_checkpoint, save_checkpoint


@pytest.mark.parametrize("shape", [(7,), (5, 6), (8, 8, 8), (3, 4, 5, 6)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_laplacian_bands_bitwise_equal(shape, dtype):
    o, d = laplacian._laplacian_bands(shape, dtype)
    oj, dj = jlaplacian._laplacian_bands(shape, dtype)
    assert o == oj
    assert d.dtype == dj.dtype and np.array_equal(d, dj)


@pytest.mark.parametrize("shape", [(8, 8, 8), (12, 10)])
def test_from_numpy_round_trips_a_reference_operator(shape):
    jop = jlaplacian.laplacian_dia(shape, dtype=jnp.float64)
    op = DIAOperator.from_numpy(np.asarray(jop.diags), jop.offsets, jop.wrap_zero, device="cpu")
    assert op.offsets == jop.offsets and op.wrap_zero == jop.wrap_zero
    assert op.dtype == torch.float64
    assert np.array_equal(op.diags.numpy(), np.asarray(jop.diags))
    built = laplacian.laplacian_dia(shape, dtype=torch.float64, device="cpu")
    assert torch.equal(built.diags, op.diags) and built.offsets == op.offsets
    Xt = np.random.default_rng(0).standard_normal((3, op.n))
    np.testing.assert_allclose(op.matmat_t(torch.from_numpy(Xt)).numpy(),
                               np.asarray(jop._matmat_t_xla(jnp.asarray(Xt))),
                               rtol=1e-12, atol=1e-12)
    X = Xt.T.copy()
    np.testing.assert_allclose(op(torch.from_numpy(X)).numpy(),
                               laplacian.laplacian_scipy(shape) @ X, rtol=1e-12, atol=1e-12)


def test_from_scipy_matches_reference():
    rng = np.random.default_rng(1)
    n, offsets = 300, [-40, -1, 0, 3, 77]
    a = sp.diags([rng.standard_normal(n - abs(o)) for o in offsets], offsets,
                 shape=(n, n)).tocsr()
    op = DIAOperator.from_scipy(a, dtype=torch.float64, device="cpu")
    jop = JDIAOperator.from_scipy(a, dtype=jnp.float64)
    assert op.offsets == jop.offsets
    assert np.array_equal(op.diags.numpy(), np.asarray(jop.diags))
    X = rng.standard_normal((n, 2))
    np.testing.assert_allclose(op.matmat(torch.from_numpy(X)).numpy(), a @ X,
                               rtol=1e-12, atol=1e-12)


def test_astype_builds_a_new_operator():
    op = laplacian.laplacian_dia((4, 4), device="cpu")
    op64 = astype(op, torch.float64)
    assert op.dtype == torch.float32 and op64.dtype == torch.float64
    assert op64.offsets == op.offsets and op64.wrap_zero
    assert torch.equal(op64.diags.float(), op.diags)


def test_assert_wrap_zero_rejects_populated_wraps():
    vals = np.ones((2, 10))
    with pytest.raises(AssertionError, match="offset \\+2"):
        assert_wrap_zero(vals, (0, 2), 10)
    vals[1, 8:] = 0.0
    assert_wrap_zero(vals, (0, 2), 10)


def test_presets_match_reference():
    op, B, meta = presets.config5_sbcgrq_3d_256(shape=(6, 6, 6), device="cpu")
    jop, jB, jmeta = jpresets.config5_sbcgrq_3d_256(shape=(6, 6, 6))
    assert meta == jmeta and op.offsets == jop.offsets
    assert np.array_equal(B.numpy(), np.asarray(jB))
    assert np.array_equal(presets._rhs(1000, 32, torch.float32, device="cpu").numpy(),
                          np.asarray(jpresets._rhs(1000, 32, jnp.float32)))
    assert presets.PRESETS["sbcgrq_3d_64"] is presets.config3_sbcgrq_3d_64


def test_checkpoint_format_is_shared(tmp_path):
    X = np.random.default_rng(2).standard_normal((50, 3))
    p1, p2 = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    save_checkpoint(p1, torch.from_numpy(X), iteration=4, meta={"tol": 1e-10})
    Xj, it, meta = jload(p1)
    assert np.array_equal(np.asarray(Xj), X) and it == 4 and float(meta["tol"]) == 1e-10
    jsave(p2, jnp.asarray(X), iteration=7)
    Xt, it, _ = load_checkpoint(p2, device="cpu")
    assert np.array_equal(Xt.numpy(), X) and it == 7
    assert load_checkpoint(str(tmp_path / "missing.npz")) is None


def test_builders_default_to_the_card():
    """Every builder, preset and ``from_numpy``/``from_scipy`` of the port
    puts its operator on the card unless the caller names a device (the CPU
    tests pass ``device="cpu"``), and ``load_checkpoint`` its X."""
    import inspect

    import blockcg_tpu_torch.problems as problems
    from blockcg_tpu_torch.operators import (
        BlockDIAOperator,
        ConstBlockDIAOperator,
        DenseOperator,
    )

    builders = [getattr(problems, name) for name in (
        "laplacian_dia", "dirac_cbdia", "dirac_gauged_cbdia", "dirac_bdia", "dirac_gauged",
        "dirac_gauged_matrix", "dirac_eo", "dirac_gauged_eo", "dirac_gauged_matrix_eo")]
    builders += list(problems.PRESETS.values()) + [presets._rhs]
    builders += [DIAOperator.from_numpy, DIAOperator.from_scipy, DenseOperator.from_numpy,
                 ConstBlockDIAOperator.from_numpy, BlockDIAOperator.from_numpy]
    builders += [load_checkpoint]
    for fn in builders:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
