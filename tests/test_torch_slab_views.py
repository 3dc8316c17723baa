"""The (k, bs, ns) view's slab adds (rows 18 and 21) on ``csrc/slab_stream.cu``,
on CPU tensors: their launch arguments (one launch a slab add at any k, the
view's row map (sa, si) = (1, bs) beside the merged view's (k, 1)), and their
plain versions against the reference package.

The same inputs, made from numpy seeds, go through both packages. Row 18
(``slab_block_accumulate``) is held to the reference's Pallas kernel in
interpret mode; row 21 (``slab_block_accumulate_from``), whose reference
body is broken (it passes ``_slab_kernel`` three extra arguments), to the
reference's ``slab_m_accumulate_from`` in interpret mode on the merged form
of the same fields, the contract its docstring names. Tolerance: max
relative error 1e-5 on the f32 fields (the reference's products run through
its MXU weight ``H ⊗ I_k``, the port's one hop entry at a time).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockcg_tpu.ops import const_block_stencil as jcbs
from blockcg_tpu.problems import dirac as jdirac
from blockcg_tpu_torch.ops import _native
from blockcg_tpu_torch.ops import const_block_stencil as cbs

H100_SMEM = 232448  # bytes of shared memory one block may opt into on an H100
H100_SMS = 132
RTOL = 1e-5


def _relmax(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _merged(F):
    """The merged (bs * k, ns) form of a (k, bs, ns) field (row a * k + i)."""
    k, bs, ns = F.shape
    return np.ascontiguousarray(F.transpose(1, 0, 2).reshape(bs * k, ns))


@pytest.fixture
def launches(monkeypatch):
    """The wrappers' kernel route on CPU tensors: every operand counts as a
    CUDA float32 one (``f32_kernel``), the card is an H100, and each launch
    is recorded instead of run."""
    calls = []
    monkeypatch.setattr(_native, "f32_kernel", lambda *t: True)
    monkeypatch.setattr(_native, "max_smem", lambda index: H100_SMEM)
    monkeypatch.setattr(_native, "sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(_native, "launch", lambda name, fn, dev, *a: calls.append((name, fn, a)))
    return calls


@pytest.mark.parametrize("k", [1, 3, 12, 24])
@pytest.mark.parametrize("g", [256, 6])
def test_view_slab_add_is_one_stream_launch(launches, k, g):
    """Row 18 on a wrap slab (2 blocks of g sites from the blocks 3 away) and
    row 21 on a halo (2 blocks of a 4-block source into blocks 5, 6 of 8):
    one ``csrc/slab_stream.cu`` launch each at any k (no chunks of
    right-hand sides), the 16-byte route where g % 4 == 0 and the 4-byte one
    elsewhere, no ``vals``, no Gram, the view's row map (1, bs), the plan's
    grid; the merged wrappers on the same geometry pass (k, 1)."""
    bs = 4
    hop = torch.eye(bs) + 0.5
    Xv, Yv = torch.zeros((k, bs, 8 * g)), torch.zeros((k, bs, 8 * g))
    Src = torch.zeros((k, bs, 4 * g))
    cbs.slab_block_accumulate(hop, g, 2, 1, 4, 3, Xv, Yv)
    cbs.slab_block_accumulate_from(hop, g, 2, 5, 1, Src, Yv)
    Xm, Ym, Sm = (F.reshape(bs * k, -1) for F in (Xv, Yv, Src))
    cbs.slab_m_accumulate(hop, g, 2, 1, 4, 3, Xm, Ym)
    cbs.slab_m_accumulate_from(hop, g, 2, 5, 1, Sm, Ym)
    assert [name for name, _, _ in launches] == [
        "slab_block_accumulate", "slab_block_accumulate_from", "slab_m_accumulate",
        "slab_m_accumulate_from"]
    fn = "bcg_slab_stream" if g % 4 == 0 else "bcg_slab_stream_scalar"
    plan = cbs.slab_plan(bs * k, bs, g, 2, False, g % 4 == 0, H100_SMS, H100_SMEM)
    for (name, f, a), (X, xn, dst, src) in zip(launches, 2 * [
            (Xv, 8 * g, (1, 4), (1, 7)), (Src, 4 * g, (1, 5), (1, 1))]):
        assert f == fn
        assert a[:8] == (hop.data_ptr(), bs, g, 2, *dst, *src)
        assert a[8:10] == (X.data_ptr(), xn) and a[12] == Yv.data_ptr()
        assert a[10:12] == (None, None) and a[13:17] == (None,) * 4
        view = name.startswith("slab_block")
        assert a[17:] == (k, 8 * g, *((1, bs) if view else (k, 1)), 0, 0, plan.grid)


@pytest.mark.parametrize("k", [1, 3])
def test_view_slab_add_matches_the_reference(k):
    """Row 18 on each z-wrap slab of ``dirac_cbdia(16)`` (g = 256 sites, the
    source 15 blocks away) in place on Y, against the reference's Pallas
    kernel in interpret mode; the sites outside the slabs untouched."""
    jop = jdirac.dirac_cbdia(16, dtype=jnp.float32)
    rng = np.random.default_rng(2410 + k)
    Xv, Yv = (rng.standard_normal((k, 4, jop.ns)).astype(np.float32) for _ in range(2))
    Y = torch.from_numpy(Yv.copy())
    Yj = jnp.asarray(Yv)
    for d, g, nblocks, mul, off, shift in jop.slabs:
        args = (jop.hops[d], g, nblocks, mul, off, shift)
        out = cbs.slab_block_accumulate(*args, torch.from_numpy(Xv), Y)
        assert out is Y
        Yj = jcbs.slab_block_accumulate(*args, jnp.asarray(Xv), Yj, interpret=True)
    assert _relmax(Y.numpy(), Yj) <= RTOL
    touched = np.zeros(jop.ns, bool)
    for d, g, nblocks, mul, off, shift in jop.slabs:
        touched[cbs.slab_columns(g, nblocks, mul, off, shift, jop.ns)[0].numpy()] = True
    assert np.array_equal(Y.numpy()[:, :, ~touched], Yv[:, :, ~touched])


@pytest.mark.parametrize("k", [1, 3])
def test_view_halo_slab_add_matches_the_reference(k):
    """Row 21 on a ``dirac_cbdia(16)`` hop: 3 blocks of g = 256 from block 1
    of a 4-block halo into blocks 5..7 of 8, in place on the (k, bs, ns) Y,
    against the reference's ``slab_m_accumulate_from`` in interpret mode on
    the merged fields; at k = 1 the two layouts are the same memory."""
    jop = jdirac.dirac_cbdia(16, dtype=jnp.float32)
    hop = jop.hops[5]
    rng = np.random.default_rng(2420 + k)
    bs, g, nb, dst_base, src_base = 4, 256, 3, 5, 1
    Src = rng.standard_normal((k, bs, 4 * g)).astype(np.float32)
    Yv = rng.standard_normal((k, bs, 8 * g)).astype(np.float32)
    Y = torch.from_numpy(Yv.copy())
    out = cbs.slab_block_accumulate_from(hop, g, nb, dst_base, src_base, torch.from_numpy(Src),
                                         Y)
    assert out is Y
    Yj = jcbs.slab_m_accumulate_from(hop, g, nb, dst_base, src_base, jnp.asarray(_merged(Src)),
                                     jnp.asarray(_merged(Yv)), interpret=True)
    assert _relmax(_merged(Y.numpy()), Yj) <= RTOL
    cols = np.r_[0:dst_base * g, (dst_base + nb) * g:8 * g]
    assert np.array_equal(Y.numpy()[:, :, cols], Yv[:, :, cols])
    if k == 1:
        Ym = torch.from_numpy(_merged(Yv))
        cbs.slab_m_accumulate_from(hop, g, nb, dst_base, src_base,
                                   torch.from_numpy(_merged(Src)), Ym)
        assert torch.equal(Ym, Y.reshape(bs, -1))
