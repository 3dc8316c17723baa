#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``blockcg_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card and
nvcc:

    python3 chip_smoke.py

It builds the kernels from ``blockcg_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version at its path's shapes (and the single-RHS
const-hop route against the merged kernels, bit for bit), then drives the
paths: SBCGrQ on config 3 (64^3 Laplacian, 32 RHS) and the north-star
``solve_refined`` to 1e-10 on the 128^3 Laplacian with 32 RHS; config 4,
the 32^4 lattice-Dirac operator in the const-hop container with 12 RHS,
through ``solve_sbcgrq`` (twice, bitwise identical) and ``solve_refined`` to
1e-10; configs 1 and 2 (2D Laplacians, 128^2 with 4 RHS and 512^2 with 16)
through ``solve_cg``, ``solve_bcg`` (twice, bitwise identical), ``solve_bcga``,
``solve_bcgdq`` and ``solve_refined(inner_solver="bcg")`` to 1e-10; and the
multi-shift solvers on config 4 with four shifts; the matrix-link lattice
operator ``dirac_gauged_matrix(32)`` in the per-site block container with 12
RHS through ``solve_sbcgrq`` (twice, bitwise identical), the public
``op(X)`` and ``solve_refined`` to 1e-10; ``dirac_bdia(32)``, config 4's
matrix in that container, against config 4's const-hop solve; and complex
systems with 6 RHS on ``realify(dirac_gauged_matrix(32, complex64))`` and
the U(1) ``dirac_gauged_cbdia(32, complex64)``; then the preconditioned
solves: Jacobi PSBCGrQ and PBCG on a badly scaled 128^3 Laplacian with 32
RHS beside capped unpreconditioned SBCGrQ (``[precond]``), Chebyshev SBCGrQ
on config 3 and at 128^3 (``[cheb]``), and the even-odd Schur path on 32^4
(``[eo]``: ``solve_dirac_eo`` on ``dirac_eo(32)`` with config 4's 12 RHS,
twice and against config 4's full solve, its CG on one column, the
multi-shift solve, the matrix-link and the U(1) complex contexts); then
fields of 96 rows, above one launch's 64 (``[kernel]`` lines at m = 96 for
every kernel the row-chunked launches serve, and for the Gram, one launch
there, with U is V as well; the fused updates again at
800 rows, where shared memory leaves room for narrow row chunks only, and
``[wide]``: config 4 with 24 RHS and the even-odd multi-shift solve with
12); ``qr_px_update``
against its plain version and against the pair it fuses; and general
sparsity: ``[sparse]`` (``rgg_laplacian(524288, degree=40)`` through
``from_scipy_auto``, which must pick the RCM tile format, SBCGrQ with 32 RHS
twice, bitwise identical, and ``solve_refined`` to 1e-10 with f32 tiles,
twice, bitwise identical, and with bf16 tiles; ``tiled_spmm_t`` at that
shape), ``[scattered]`` (the reference's
``bench_scattered.py`` problems in the CSR, ELL and tile formats) and
``[bell]`` (config 4's matrix as site-major BSR against the const-hop
solve); then the distributed layer on one rank, an NCCL group of one on
cuda:0 (the halo slab adds, rows 20 and 21, against their plain versions at
config 4's and the even-odd hop's crossings; ``[dist]``: the row-partitioned
north star to 1e-10, config 4, the even-odd solve on 12 RHS and on one,
the matrix-link operator and config 3's BCG, CG, shifted, Jacobi and
Chebyshev solves, each beside its single-device run with the time ratio).
Before the distributed layer, config 5 at full size (the 256^3 Laplacian,
64 RHS): ``[config5] kernels`` holds each bf16 variant (rows 1-2, 5-9)
against its plain version at (32, 256^3) on the bf16 operator, beside the
f32 kernel at that shape (rows 5 and 6, on the tensor cores, also beside
the f32-FMA kernels they replaced; row 5 as U V^T and as U U^T, the
symmetric Gram the lean path launches); ``[config5] lean`` drives ``solve_refined_lean``
on the bf16 preset (inner slices of 32, tol 1e-6) to a true f64 relres <=
1e-6 within 16 GiB of allocated memory; ``[config5] qr2``, row 7's own path,
runs its first inner solve again at ``qr_passes=2`` (the second QR pass,
which the adaptive default did not take on the lean path) beside the same
solve at ``qr_passes=1``; and ``[config5] f32`` drives ``solve_refined`` on
the f32 preset to the same tol. Then the bf16 presets of configs 1-4
(``[bf16presets]``, as ``bench_cli.py --dtype bf16 [--refined]`` runs them):
``xr_update_gram[bf16]``, ``qr_p_update[bf16]`` and ``qr_px_update[bf16]``
against their plain versions at (16, 512^2), (48, 32^4) and m = 96
(``qr_px_update[bf16]`` also at 16, 64 and 96 rows, fresh and donated, on
its routes: ``px_update_mma``'s QR-with-X mode up to 64 rows, the
streaming kernel's above); then,
at full size, CG on config 1's column 0, BCG, BCGA and BCGdQ on config 2,
SBCGrQ on configs 3 and 4 (config 4's const-hop applies on the plain route,
no const-hop kernel launched), each beside ``solve_refined`` on the bf16
operator and the f32 B to 1e-6 (up to 16 cycles: config 2's, with inner
BCG, takes about 11). Then ``[storage]``: the matrix-link operator with its
folded wraps (``BLOCKCG_FOLD``), its bf16-block and folded kernels and the
mixed-dtype and wide bf16 DIA stencil kernels against their plain versions,
then SBCGrQ on the bf16-stored, the folded and the folded bf16-stored
matrix link, on the 128^3 Laplacian with bf16 diagonals and f32 fields and
with f32 diagonals and bf16 fields, and on the bf16 Laplacian with 96 RHS.
The routes of the wrappers with several kernels are held by the library
function each launch called (``_native.functions``): ``[config5] lean``'s
bf16 stencil launches without the Gram take the ring of planes, and so do
the 128^3 solve's launches on bf16 diagonals and f32 fields in
``[storage]`` (row 1m, ``bcg_stencil_ring_bf16d``); every folded launch of
``[storage]``'s folded solves takes the TMA boxes; the ``[plan]`` lines
print those launches' plans.
Each phase prints one or a few lines; any failure raises, and the process exits
non-zero. The last two lines are the kernels' JSON record, whose launch
counts are those of each kernel's own path (the north-star solves, config 4,
configs 1 and 2, the multi-shift solves, the matrix-link solves, the
Chebyshev solves, the even-odd CG, the sparse solves or the ``[dist]``
solves, the ``[config5] lean`` solve for the bf16 variants of rows 1-9,
config 2's bf16 solves for ``xr_update_gram[bf16]``; the (k, bs, ns) Gram,
``qr_px_update`` and the bf16 ``qr_p_update`` and ``qr_px_update`` have no
solver caller and count 0, nor does ``mm_update_gram[bf16]`` on the lean
path), with each kernel's bound (the
larger of its contract's bytes over 3.35 TB/s and its FLOPs over 67 TFLOP/s,
989 TFLOP/s for products of bf16 fields: the H100 SXM's data-sheet peaks) and, where one PyTorch call
computes the same function, that call's time; and the run's JSON result. It
imports neither JAX nor the reference package, and fails without a card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

FIELD_RTOL = 1e-5  # max |kernel - plain| / max |plain| for field outputs
CHEB_RTOL = 1e-6  # cheb_step's fields (the kernel rounds as the plain version does)
GRAM_RTOL = 1e-5  # relative Frobenius error of Grams (summation order differs)
K = 32
SHAPES = ((128, 128, 128), (64, 64, 64))  # north star, config 3
REPS = 20

# Wrapper name -> (CUDA source, the TPU kernel it replaces). At >= 1M rows the
# reference dispatches the ring schedule (blockcg_tpu/ops/stencil_ring.py:288,
# :304) with the same contract as the windowed stencil listed here.
KERNELS = {
    "stencil_spmm_t": ("blockcg_tpu_torch/csrc/stencil.cu", "blockcg_tpu/ops/stencil.py:264"),
    "stencil_spmm_gram_t": ("blockcg_tpu_torch/csrc/stencil.cu", "blockcg_tpu/ops/stencil.py:282"),
    "gram": ("blockcg_tpu_torch/csrc/gram.cu", "blockcg_tpu/ops/fused.py:203"),
    "mm_update": ("blockcg_tpu_torch/csrc/mm_update.cu", "blockcg_tpu/ops/fused.py:265"),
    "mm_update_gram": ("blockcg_tpu_torch/csrc/mm_update_gram.cu", "blockcg_tpu/ops/fused.py:332"),
    "mm2_update_gram": ("blockcg_tpu_torch/csrc/mm2_update_gram.cu",
                        "blockcg_tpu/ops/fused.py:405"),
    "px_update": ("blockcg_tpu_torch/csrc/px_update.cu", "blockcg_tpu/ops/fused.py:588"),
    "const_block_stencil_spmm_m_t": ("blockcg_tpu_torch/csrc/cbs_merged.cu",
                                     "blockcg_tpu/ops/const_block_stencil.py:617"),
    "const_block_stencil_spmm_m_gram_t": ("blockcg_tpu_torch/csrc/cbs_merged.cu",
                                          "blockcg_tpu/ops/const_block_stencil.py:637"),
    "slab_m_accumulate": ("blockcg_tpu_torch/csrc/slab_stream.cu",
                          "blockcg_tpu/ops/const_block_stencil.py:780"),
    "xr_update_gram": ("blockcg_tpu_torch/csrc/xr_update.cu", "blockcg_tpu/ops/fused.py:496"),
    "qr_p_update": ("blockcg_tpu_torch/csrc/px_update.cu", "blockcg_tpu/ops/fused.py:730"),
    # The reference dispatches its ring schedule (block_stencil_ring.py:359,
    # :371) at 32^4 with the contract of the two merged kernels listed here.
    "block_stencil_spmm_m_t": ("blockcg_tpu_torch/csrc/block_stencil.cu",
                               "blockcg_tpu/ops/block_stencil.py:371"),
    "block_stencil_spmm_m_gram_t": ("blockcg_tpu_torch/csrc/block_stencil.cu",
                                    "blockcg_tpu/ops/block_stencil.py:383"),
    "block_stencil_spmm_t": ("blockcg_tpu_torch/csrc/block_stencil.cu",
                             "blockcg_tpu/ops/block_stencil.py:94"),
    "cheb_step": ("blockcg_tpu_torch/csrc/cheb_step.cu", "blockcg_tpu/ops/fused.py:670"),
    "const_block_stencil_spmm_t": ("blockcg_tpu_torch/csrc/cbs_merged.cu",
                                   "blockcg_tpu/ops/const_block_stencil.py:330"),
    "const_block_stencil_spmm_gram_t": ("blockcg_tpu_torch/csrc/const_block_stencil.cu",
                                        "blockcg_tpu/ops/const_block_stencil.py:361"),
    "slab_block_accumulate": ("blockcg_tpu_torch/csrc/slab_stream.cu",
                              "blockcg_tpu/ops/const_block_stencil.py:691"),
    "tiled_spmm_t": ("blockcg_tpu_torch/csrc/spmm_tiled.cu", "blockcg_tpu/ops/spmm_tiled.py:63"),
    "qr_px_update": ("blockcg_tpu_torch/csrc/px_update.cu", "blockcg_tpu/ops/fused.py:795"),
    "slab_m_accumulate_from": ("blockcg_tpu_torch/csrc/slab_stream.cu",
                               "blockcg_tpu/ops/const_block_stencil.py:846"),
    "slab_block_accumulate_from": ("blockcg_tpu_torch/csrc/slab_stream.cu",
                                   "blockcg_tpu/ops/const_block_stencil.py:955"),
}
# The bf16 variants: wrapper[bf16] -> (source, the TPU kernel whose bf16
# branch it replaces). Config 5's capacity route launches the first seven;
# the bf16 presets of configs 1-4 the others (qr_p_update and qr_px_update
# have no bf16 solver path: the reference's shifted-block SBCGrQ fails on
# bf16 fields, and nothing calls qr_px_update).
CONFIG5_BF16 = tuple(f"{w}[bf16]" for w in (
    "stencil_spmm_t", "stencil_spmm_gram_t", "gram", "mm_update", "mm_update_gram",
    "mm2_update_gram", "px_update"))
PRESETS_BF16 = ("xr_update_gram[bf16]", "qr_p_update[bf16]", "qr_px_update[bf16]")
BF16_KERNELS = {w: KERNELS[w.removesuffix("[bf16]")] for w in (*CONFIG5_BF16, *PRESETS_BF16)}
# [storage]'s variants -> (source, the TPU kernel whose mode it replaces):
# bf16 blocks with f32 fields on the per-site block stencil (rows 22h, 23h),
# its folded wraps (24f, 24fg, and 24f on bf16 blocks), the mixed-dtype DIA
# stencil (1m, 2m: bf16 diagonals; 1x, 2x: a bf16 field) and the bf16
# stencil's Gram above one launch's 64 rows (2w).
STORAGE_BLOCK_BF16 = ("block_stencil_spmm_t[bf16 coeffs]", "block_stencil_spmm_m_t[bf16 coeffs]")
STORAGE_STENCIL = ("stencil_spmm_t[bf16 coeffs]", "stencil_spmm_gram_t[bf16 coeffs]",
                   "stencil_spmm_t[bf16 field]", "stencil_spmm_gram_t[bf16 field]")
RING_BS = "blockcg_tpu/ops/block_stencil_ring.py"
STORAGE_KERNELS = {
    **{w: KERNELS[w.split("[")[0]] for w in (*STORAGE_BLOCK_BF16, *STORAGE_STENCIL)},
    "block_stencil_spmm_m_t[fold]": (KERNELS["block_stencil_spmm_m_t"][0], f"{RING_BS}:359"),
    "block_stencil_spmm_m_gram_t[fold]": (KERNELS["block_stencil_spmm_m_t"][0],
                                          f"{RING_BS}:371"),
    "block_stencil_spmm_m_t[fold, bf16 coeffs]": (KERNELS["block_stencil_spmm_m_t"][0],
                                                  f"{RING_BS}:359"),
    "stencil_spmm_gram_t[bf16, wide]": KERNELS["stencil_spmm_gram_t"],
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 products with f32 sums, tensor cores, dense
# The kernels of config 4's const-hop operator and of the per-site block
# operator; the others are the north star's.
CBS_KERNELS = ("const_block_stencil_spmm_m_t", "const_block_stencil_spmm_m_gram_t",
               "slab_m_accumulate")
BS_KERNELS = ("block_stencil_spmm_m_t", "block_stencil_spmm_m_gram_t", "block_stencil_spmm_t")
# The (k, bs, ns) const-hop kernels: the even-odd CG runs the apply and the
# slab add; the Gram variant has no solver caller, in the reference too.
VIEW_KERNELS = ("const_block_stencil_spmm_t", "slab_block_accumulate")
NORTH_STAR_KERNELS = tuple(w for w in KERNELS if w not in (
    *CBS_KERNELS, *BS_KERNELS, *VIEW_KERNELS, "const_block_stencil_spmm_gram_t",
    "xr_update_gram", "qr_p_update", "cheb_step", "tiled_spmm_t", "qr_px_update",
    "slab_m_accumulate_from", "slab_block_accumulate_from"))
CONFIG3_WRAPPERS = ("stencil_spmm_t", "stencil_spmm_gram_t", "gram", "mm_update",
                    "mm2_update_gram", "px_update")
# Every SBCGrQ solve at qr_passes=1 launches these fused kernels
# (mm_update_gram only when the adaptive second QR pass triggers).
CONFIG4_WRAPPERS = (*CBS_KERNELS, "gram", "mm_update", "mm2_update_gram", "px_update")
DIRAC_L = 32
DIRAC_K = 12
DIRAC_REF_ITERS = 13  # the reference's SBCGrQ iterations at tol 1e-6
# BCG, BCGA and BCGdQ on config 2 launch these (the stencil with its Gram,
# xr_update_gram in BCG and BCGA, the Gram-carrying updates in BCGdQ).
CONFIG12_WRAPPERS = ("stencil_spmm_t", "stencil_spmm_gram_t", "gram", "mm_update",
                     "mm_update_gram", "xr_update_gram")
# The multi-shift solves on config 4 (qr_passes=2: mm_update_gram each step;
# no apply without the Gram).
SHIFTED_WRAPPERS = ("const_block_stencil_spmm_m_gram_t", "slab_m_accumulate", "gram",
                    "mm_update", "mm_update_gram", "qr_p_update")
SHIFTS = (0.0, 0.05, 0.5, 2.0)
# The matrix-link solves (SBCGrQ at qr_passes=1, the public f32 op(X) on the
# flat field, solve_refined) launch these.
MATRIXLINK_WRAPPERS = (*BS_KERNELS, "gram", "mm_update", "mm2_update_gram", "px_update")
ML_L = 32
ML_K = 12
ML_SEED = 1234  # the reference's bench.py draws the matrix-link field from this seed
COMPLEX_K = 6
COMPLEX_ML_L = 32
# dirac_bdia(32) against config 4's const-hop solve: two f32 solves of one
# matrix to tol 1e-6, whose X may differ by up to cond(A) * tol (cond <= 65).
BDIA_X_RTOL = 1e-4
# Config 1's true f64 residual after f32 CG at tol 1e-6: the recurrence
# understates it, and the reference's own f32 CG ends at 9.9e-6 to 2.6e-5 on
# these four columns (its CPU run, the same iteration counts as the port's).
CG1_TRUE_RELRES = 5e-5
# Even-odd SBCGrQ on dirac_eo(32) against config 4's full solve: both stop at
# tol 1e-6 on an operator with cond(A) <= 65, so their X may differ by about
# cond * tol.
EO_X_RTOL = 1e-4
EO_COMPLEX_K = 6  # 6 complex RHS: 12 real columns on the bs = 8 realified context
# The even-odd multi-shift solve runs on [b_e | H_eo b_o], 2k columns: k = 6
# of config 4's RHS keep its merged fields at config 4's m = 48, one launch
# a kernel (``[wide]`` runs all 12 RHS, m = 96, as row-chunked launches).
EO_SHIFTED_K = 6
PRECOND_SHAPE = (128, 128, 128)
PRECOND_CAP = 500  # unpreconditioned SBCGrQ does not converge in f32: capped
CHEB_RUNS = ((64, 6), (128, 4))  # (Laplacian edge, Chebyshev degree), k = 32
# cheb_step's widths: the 128^3 Chebyshev solve's (32, 2,097,152), config 4's
# merged (48, 32^4).
CHEB_STEP_SHAPES = ((K, 128 ** 3), (4 * DIRAC_K, DIRAC_L ** 4))
# General sparsity: the largest RGG graph the reference's default tile budget
# (8 GiB) takes at degree 40, 32 RHS.
SPARSE_N = 524288
SPARSE_DEGREE = 40
SPARSE_K = 32
SPARSE_WIDE_K = 96  # tiled_spmm_t above the other kernels' 64 rows a launch
SCATTERED_N = 32768  # bench_scattered.py's size (16,384 for the no-locality graphs)
# Fields wider than one launch: m = 96 rows (24 RHS on config 4, 12 RHS of
# the even-odd multi-shift solve on 2k = 24 columns).
WIDE_M = 96
WIDE_CONFIG4_K = 24
# A width whose staged k-column coefficients leave room in shared memory for
# narrow row chunks only (16 rows for mm2_update_gram, whose plan names them;
# 32 for xr_update_gram, whose plan takes chunks of more than 32 rows up to
# k = 652), on a short field.
NARROW_CHUNK_K = 800
NARROW_CHUNK_N = 2 ** 16
# The fused SBCGrQ tail against the pair it replaces: (32, 128^3), (48, 32^4).
QR_PX_SHAPES = ((K, 128 ** 3), (4 * DIRAC_K, DIRAC_L ** 4))
# dirac_bell(32) (site-major BSR) against config 4's const-hop solve.
BELL_X_RTOL = 1e-6
# The m = 96 solves (config 4's SBCGrQ on 24 RHS, the even-odd multi-shift
# solve on 12) launch these: the merged stencil and the slab adds one launch
# a call (``[wide]`` checks one a slab add), the others row-chunked launches.
WIDE_WRAPPERS = ("const_block_stencil_spmm_m_t", "slab_m_accumulate", "gram",
                 "mm2_update_gram", "px_update", "qr_p_update")
SPARSE_WRAPPERS = ("tiled_spmm_t", "gram", "mm2_update_gram", "px_update")
# The distributed layer on one rank (NCCL, a group of one): the halo slab
# adds keep the [dist] solves' counts; the merged one carries config 4's
# t-hop crossings, the view's those of the one-RHS even-odd solve.
DIST_KERNELS = ("slab_m_accumulate_from", "slab_block_accumulate_from")
DIST_ML_ITERS = 10  # dirac_gauged_matrix(32), 12 RHS: the single-device count
DIST_EO_ITERS = 7  # dirac_eo(32) with config 4's B
DIST_CHEB_DEGREE = 6
# Config 5 (BASELINE.json configs[4]) at full size: the 256^3 Laplacian, 64
# RHS; the lean route's inner slices, the seed of its B, the tolerance of
# both routes and the lean route's budget of allocated memory.
CONFIG5_SHAPE = (256, 256, 256)
CONFIG5_K = 64
CONFIG5_KB = 32
CONFIG5_SEED = 0
CONFIG5_TOL = 1e-6
CONFIG5_INNER_TOL = 5e-3  # solve_refined_lean's inner_tol
# [config5] qr2: the second QR pass changes rounding alone, so the solve at
# qr_passes=2 takes the iterations of the one at qr_passes=1 within 5% (at
# least 3) and reaches its true relres within a factor 1.5.
QR2_ITERS = 0.05
QR2_RELRES = 1.5
# A Gram's contract told apart from the other candidate (the Gram of the
# stored bf16 Y against that of the unrounded f32 sums): at config 5's shape
# the kernel must be nearer its own; on a 64^3 cut, where the f32 sums are
# shorter, nearer by GRAM_MARGIN.
CONFIG5_CUT = (64, 64, 64)
GRAM_MARGIN = 4.0
CONFIG5_PEAK_GIB = 16.0
# A stored bf16 element within one bf16 ulp of the plain version's, an element
# below 2^-8 of the field's largest held to the ulp at that floor (a sum that
# cancels keeps the f32 rounding error of its terms).
BF16_ULPS = 1.0
# Grams over config 5's 16.7M columns against the plain version's: two f32
# sums of 16.7M products in different orders (cuBLAS's f32 Gram of the plain
# version is the less accurate of the two). Each kernel's Gram of stored
# bf16 fields is also held to GRAM_RTOL against its f64 sum.
C5_GRAM_RTOL = 1e-4
# Rows 2, 5-9 in bf16 run on the tensor cores; the f32-FMA kernels they
# replaced, at (32, 256^3) on an H100 80GB HBM3 at 700 W: px_update 4.4352
# ms and 1 bf16 ulp from the plain version, the Gram 1.4972 ms
# and 9.300e-07 from its f64 sum, Y = M B 1.3576 ms and 0 bf16 ulps from the
# plain version; the stencil with its Gram 4.6279 ms, its Gram 3.539e-08
# from the f64 Gram of its contract (X Y^T of the f32 sums); mm_update_gram
# 2.5136 ms and mm2_update_gram 3.9716 ms, their Grams 2.377e-06 and
# 2.481e-06 from theirs (Y Y^T of the stored Y). Printed beside this run's
# figures.
TENSOR_CORE_ROWS_BEFORE = {
    "px_update[bf16]": (4.4352, "1 bf16 ulp from the plain version"),
    "gram[bf16]": (1.4972, "9.300e-07 from the f64 Gram"),
    "mm_update[bf16]": (1.3576, "0.00 bf16 ulps from the plain version"),
    "stencil_spmm_gram_t[bf16]": (4.6279, "3.539e-08 from the f64 Gram of its contract"),
    "mm_update_gram[bf16]": (2.5136, "2.377e-06 from the f64 Gram of its contract"),
    "mm2_update_gram[bf16]": (3.9716, "2.481e-06 from the f64 Gram of its contract"),
}
# [bf16presets]: configs 1-4 in bf16 as bench_cli.py --dtype bf16 runs them
# (tol 1e-6, max_iter 2000; --refined: solve_refined with inner_tol 5e-3, the
# f64 outer loop and the f32 B, inner BCG on config 2 and SBCGrQ on the
# others), at full size. The refined solves are held to the true f64 relres
# PRESETS_TOL against the f32 B; the plain solves' true relres is printed,
# not held (a bf16 solve's true residual stalls at X's rounding), and their
# X must stay bf16 and finite. Each refinement cycle contracts the true
# residual only to about kappa(A) times bf16's rounding of the stored
# correction, far less than inner_tol on config 2, whose 512^2 Laplacian is
# the worst conditioned of the four: it needs about 11 cycles, past
# bench_cli's default of 8 (the verbose cycles print where the 8th ends).
# PRESETS_CYCLES lets every refined solve run to PRESETS_TOL.
PRESETS_TOL = 1e-6
PRESETS_MAX_ITER = 2000
PRESETS_INNER_TOL = 5e-3
PRESETS_CYCLES = 16
PRESETS_DIRAC_K = 4 * DIRAC_K  # config 4's merged width, m = bs * k
QR_PX_BF16_ROWS = (16, 64, 96)  # row 13b's other widths: both routes and the edge between
PRESETS_BCG_SHAPE = (16, 512 ** 2)  # config 2's field
# [storage]: the bf16 stencil's solve above one launch's 64 rows.
STORAGE_WIDE_K = 96
# Row 2w (the bf16 stencil's Gram at k = 96 on the 128^3 Laplacian) before
# its column blocks on the tensor cores: sums to an f32 (k, n) scratch, X
# lifted to f32 and the cross blocks from gram.cu; event ms on an H100 80GB
# HBM3 at 700 W and what it allocated. Printed beside this run's figures.
STORAGE_WIDE_BEFORE = (3.8448, "two f32 (k, n) copies of the field a call (1,611 MB)")
# The const-hop kernels a bf16 config 4 must not launch: their reference
# gate takes float32 alone, and the operator sends a bf16 field whole to the
# plain route (ops/_native.py f32_gate_refuses).
CONST_HOP_KERNELS = (*CBS_KERNELS, "const_block_stencil_spmm_t",
                     "const_block_stencil_spmm_gram_t", "slab_block_accumulate",
                     "slab_m_accumulate_from", "slab_block_accumulate_from")


def median_ms(torch, fn) -> float:
    """Median device time of one call, from CUDA events around each call."""
    fn()
    fn()
    pairs = []
    for _ in range(REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def relmax(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def relfro(a, b) -> float:
    import torch

    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if any(flags):
        raise RuntimeError(f"TF32 flags must be False, got {flags}")
    print(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"tf32 matmul={flags[0]} cudnn={flags[1]}")
    return smi


def phase_build() -> None:
    from blockcg_tpu_torch.ops import _native

    t0 = time.perf_counter()
    _native.library()
    print(f"[build] {_native.library_path()} from {len(_native.sources())} "
          f"sources in {time.perf_counter() - t0:.1f} s")


def _check(name, what, err, tol):
    if not err <= tol:  # also catches NaN
        raise AssertionError(f"{name}: {what} error {err:.3e} exceeds {tol:.0e}")


def nbytes(*items) -> int:
    """Bytes of tensors (and of plain counts given as ints)."""
    return sum(int(t) if isinstance(t, int) else t.numel() * t.element_size() for t in items)


def nnz(*tensors) -> int:
    """Nonzero entries of tensors: the multiply-adds a sparse operand needs."""
    import torch

    return sum(int(torch.count_nonzero(t)) for t in tensors)


def syrk_flops(k: int, n: int) -> int:
    """FLOPs of a symmetric Gram Y Y^T of a (k, n) field: its k (k + 1) / 2
    entries on and above the diagonal, 2 n each (the rest mirror them)."""
    return k * (k + 1) * n


def bound_ms(nbytes_: int, flops: int, rate: float = F32_FLOPS) -> tuple[float, str]:
    """The least time the card could take: the larger of the contract's bytes
    (each input read once, each output written once) over the HBM rate and
    its FLOPs over the peak rate of their type (``BF16_FLOPS`` for products
    of bf16 fields), and which of the two it is."""
    tb, tf = nbytes_ / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _timed_check(torch, name, what, kern, plain, is_gram, records, timed=None, *,
                 work, library=None, rtol=FIELD_RTOL) -> float:
    """Run the kernel and its plain version once, compare each output, time
    both (or the pair ``timed``), print one line, and fold the record into
    ``records[name]``. ``work`` is (bytes, FLOPs) of the contract at these
    shapes; ``library`` one PyTorch call computing the same function, or
    None; ``rtol`` the tolerance of field outputs. The first check of a
    wrapper sets its times, bound and library time; every check its
    max_abs_err. Returns the kernel's ms."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    errs, abs_err = [], 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            continue
        err = relfro(g, w) if is_gram(w) else relmax(g, w)
        _check(f"{name} ({what})", "Gram" if is_gram(w) else f"output {i}", err,
               GRAM_RTOL if is_gram(w) else rtol)
        errs.append(err)
        abs_err = max(abs_err, float((g - w).abs().max()))
    ms, plain_ms = (median_ms(torch, fn) for fn in (timed or (kern, plain)))
    bound, by = bound_ms(*work)
    lib_ms = None if library is None else median_ms(torch, library)
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    print(f"[kernel] {name} {what}: rel err {max(errs):.2e} (max abs {abs_err:.2e}), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}: "
          f"{work[0] / 1e6:.1f} MB, {work[1] / 1e9:.2f} GFLOP), library {lib}")
    rec = records.setdefault(name, {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                    "bound_ms": bound, "bound_by": by, "library_ms": lib_ms})
    rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
    return ms


def _library_check(torch, call, want, what, measure=None):
    """(call, None) when one run of the library ``call`` agrees with the
    kernel's output ``want`` (rtol 1e-4), else (None, why); a call torch
    refuses is recorded as none, with its error. With ``measure(got, want)``
    the call is kept whatever that error, which is printed: a bf16 call that
    sums less accurately than the kernel still computes its function."""
    try:
        got = call()
        if got.is_cuda:
            torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    if measure is not None:
        print(f"[library] {what}: error {measure(got, want):.3e}")
        return call, None
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max())):
        return None, f"torch's {what} disagrees with the kernel"
    return call, None


def _slab_weights(torch, hop, k):
    """W = H ⊗ I_k, the (m, m) weight of a merged slab add (the reference's
    ``_slab_weights``)."""
    return torch.kron(hop.float(), torch.eye(k, device=hop.device))


def _slab_library(torch, hop, g, nblocks, dst_mul, dst_off, src_shift, Xm, Y0, want):
    """One PyTorch call computing row 19's slab add without the Gram:
    ``Yb.baddbmm_(W.expand(nblocks, m, m), Xb)`` on strided views of the
    slab's destination and source blocks (an arithmetic run of blocks, as
    config 4's wraps are), in place on a copy of ``Y0``: held by
    ``_library_check`` to the kernel's Y ``want`` (the add on Y0), then
    timed on that copy."""
    m, ns = Xm.shape
    nb = ns // g
    src_off = (dst_off + src_shift) % nb
    span = dst_mul * (nblocks - 1)
    if dst_mul < 1 or dst_off + span >= nb or src_off + span >= nb:
        return None, "the slab's blocks wrap: no strided view"
    W = _slab_weights(torch, hop, m // hop.shape[-1]).expand(nblocks, m, m)
    Yc = Y0.clone()

    def blocks(F, off):
        return F.view(m, nb, g)[:, off:off + span + 1:dst_mul].permute(1, 0, 2)

    def call():
        return blocks(Yc, dst_off).baddbmm_(W, blocks(Xm, src_off))
    _, why = _library_check(torch, lambda: (call(), Yc)[1], want, "baddbmm_ on the slab's blocks")
    return (None, why) if why else (call, None)


def _halo_library(torch, hop, g, nblocks, dst_base, src_base, Src, Y0, want):
    """One PyTorch call computing row 20's halo slab add without ``vals`` or
    the Gram: ``Y[:, d0:d0 + cols].addmm_(W, Src[:, s0:s0 + cols])``, in
    place on a copy of ``Y0``, held to the kernel's Y ``want`` first."""
    m = Y0.shape[0]
    cols, d0, s0 = nblocks * g, dst_base * g, src_base * g
    W = _slab_weights(torch, hop, m // hop.shape[-1])
    Yc = Y0.clone()

    def call():
        return Yc[:, d0:d0 + cols].addmm_(W, Src[:, s0:s0 + cols])
    _, why = _library_check(torch, lambda: (call(), Yc)[1], want, "addmm_ on the halo slab")
    return (None, why) if why else (call, None)


def _view_halo_library(torch, hop, g, nblocks, dst_base, src_base, Src, Y0, want):
    """One PyTorch call computing row 21's halo slab add on the (k, bs, ns)
    view: ``Y[:, :, d0:d0 + cols].baddbmm_(H.expand(k, bs, bs), Src[:, :,
    s0:s0 + cols])``, in place on a copy of ``Y0``, held to the kernel's Y
    ``want`` first."""
    k, bs = Y0.shape[:2]
    cols, d0, s0 = nblocks * g, dst_base * g, src_base * g
    H = hop.float().expand(k, bs, bs)
    Yc = Y0.clone()

    def call():
        return Yc[:, :, d0:d0 + cols].baddbmm_(H, Src[:, :, s0:s0 + cols])
    _, why = _library_check(torch, lambda: (call(), Yc)[1], want,
                            "baddbmm_ on the view's halo columns")
    return (None, why) if why else (call, None)


def _slab_plans(torch, cbs, slab, Y) -> str:
    """The route and ``slab_plan`` of a merged slab add (row 19) without and
    with its Gram, as its wrapper makes them."""
    from blockcg_tpu_torch.ops import _native

    hop, g, nblocks, X = slab[0], slab[1], slab[2], slab[-1]
    m, idx = Y.shape[0], Y.device.index
    out = []
    for gram in (False, True):
        vec = cbs._slab_vec(g, X, Y, X if gram else None)
        plan = cbs.slab_plan(m, hop.shape[-1], g, nblocks, gram, vec, _native.sm_count(idx),
                             _native.max_smem(idx))
        route = "bcg_slab_stream" if vec else "bcg_slab_stream_scalar"
        out.append(f"{'with' if gram else 'without'} Gram {route} {plan.describe()}")
    return "; ".join(out)


def _dia_csr_library(torch, diags, offsets, Xt, Y, measure=None):
    """One PyTorch call computing the DIA SpMM: the torch CSR tensor of the
    same toroidal diagonals (explicit zeros dropped, columns sorted in each
    row) times the dense X^T. ``Y`` is the kernel's output, held to the call
    by ``_library_check`` (with ``measure``, if given)."""
    ndiag, n = diags.shape
    rows = torch.arange(n, device=diags.device)
    cols = torch.stack([(rows + o) % n for o in offsets], dim=1)
    vals = diags.T.contiguous()
    order = torch.argsort(cols, dim=1)
    cols, vals = cols.gather(1, order), vals.gather(1, order)
    keep = vals != 0
    crow = torch.zeros(n + 1, dtype=torch.int64, device=diags.device)
    crow[1:] = torch.cumsum(keep.sum(dim=1), 0)
    A = torch.sparse_csr_tensor(crow, cols[keep], vals[keep], size=(n, n))
    X = Xt.T.contiguous()
    return _library_check(torch, lambda: A @ X, Y.T, "CSR product", measure)


def _site_bsr_library(torch, blocks, offsets, X, Y):
    """One PyTorch call computing a per-site block stencil: the torch BSR
    tensor (blocksize bs) whose block (s, (s + o_d) mod ns) is ``blocks[d,
    :, :, s]`` times the site-major dense field. ``X`` and ``Y`` are the
    kernel's input and output in the merged (bs * k, ns) or the (k, bs, ns)
    layout; the site-major copy of X is made outside the timed call."""
    nd, bs, _, ns = blocks.shape
    if X.dim() == 3:  # (k, bs, ns)
        def site_major(F):
            return F.permute(2, 1, 0).reshape(ns * bs, -1)
    else:             # merged (bs * k, ns)
        def site_major(F):
            return F.reshape(bs, -1, ns).permute(2, 0, 1).reshape(ns * bs, -1)
    sites = torch.arange(ns, device=blocks.device)
    cols = torch.stack([(sites + o) % ns for o in offsets], dim=1)
    order = torch.argsort(cols, dim=1)
    vals = blocks.permute(3, 0, 1, 2)[sites[:, None], order]  # (ns, nd, bs, bs)
    crow = torch.arange(0, (ns + 1) * nd, nd, device=blocks.device)
    A = torch.sparse_bsr_tensor(crow, cols.gather(1, order).reshape(-1),
                                vals.reshape(ns * nd, bs, bs).contiguous(),
                                size=(ns * bs, ns * bs))
    Xs = site_major(X).contiguous()
    return _library_check(torch, lambda: A @ Xs, site_major(Y), "BSR product")


def _const_hop_blocks(torch, hops, slots, masks, ns):
    """The per-site blocks (nd, bs, bs, ns) of const-hop diagonals: each hop
    times its mask row (ones where a diagonal has no mask)."""
    ones = torch.ones(ns, device=hops.device)
    return torch.stack([hops[d][:, :, None] * (masks[s] if s >= 0 else ones)
                        for d, s in enumerate(slots)])


def _cbs_plans(op, Xm) -> str:
    """The merged const-hop launch of the operator's main diagonals on Xm:
    its ``const_block_stencil_plan`` (one launch; row 17 adds one ``gram``
    launch)."""
    k = Xm.shape[0] // op.bs
    nmask = 0 if op.masks_main is None else op.masks_main.shape[0]
    plan = op.main_plans.get(op.main_offsets, nmask, k, Xm.shape[1], Xm.device)
    return f"1 launch: {plan.describe()}"


def _library_note(name, why):
    print(f"[library] {name}: " + ("one PyTorch call timed" if why is None else f"none ({why})"))


def phase_kernels(torch, dev) -> dict:
    """Each kernel against its plain version at the main path's shapes, and
    both timed. Returns {wrapper: record}, timed at the north-star shape."""
    from blockcg_tpu_torch.ops import fused, stencil
    from blockcg_tpu_torch.problems import laplacian_dia

    records = {}
    gen = torch.Generator(device=dev).manual_seed(0)

    def field(k, n):
        return torch.randn((k, n), generator=gen, device=dev)

    def is_gram(w):
        return w.shape == (K, K)

    for shape in SHAPES:  # the north star first: its times go in the records
        op = laplacian_dia(shape, device=dev)
        n = op.n
        M1, M2, M3 = (torch.randn((K, K), generator=gen, device=dev) / K ** 0.5
                      for _ in range(3))
        B1, B2, B3 = field(K, n), field(K, n), field(K, n)
        banded = torch.randn(op.diags.shape, generator=gen, device=dev)  # wraps populated
        what = f"n={n} k={K}"
        # field, Gram bytes; FLOPs of U V^T and of the symmetric Y Y^T
        fb, gb, gf, sf = nbytes(B1), K * K * 4, 2 * K * K * n, syrk_flops(K, n)

        def spmm(diags, gram=False):
            return (nbytes(diags) + 2 * fb + gram * gb, 2 * K * nnz(diags) + gram * sf)
        csr, why = _dia_csr_library(torch, op.diags, op.offsets, B1,
                                    stencil.stencil_spmm_t(op.diags, op.offsets, B1))
        _library_note(f"stencil_spmm_t {what} (torch CSR @ dense)", why)
        cases = [
            ("stencil_spmm_t", what,
             lambda: (stencil.stencil_spmm_t(op.diags, op.offsets, B1), None),
             lambda: stencil.stencil_spmm_plain(op.diags, op.offsets, B1),
             spmm(op.diags), csr),
            ("stencil_spmm_gram_t", what,
             lambda: stencil.stencil_spmm_gram_t(op.diags, op.offsets, B1),
             lambda: stencil.stencil_spmm_plain(op.diags, op.offsets, B1, True),
             spmm(op.diags, True), None),
            ("stencil_spmm_gram_t", what + " random banded",
             lambda: stencil.stencil_spmm_gram_t(banded, op.offsets, B1),
             lambda: stencil.stencil_spmm_plain(banded, op.offsets, B1, True),
             spmm(banded, True), None),
            ("gram", what, lambda: (None, fused.gram(B1, B2)),
             lambda: (None, fused.gram_plain(B1, B2)), (2 * fb + gb, gf), lambda: B1 @ B2.T),
            ("mm_update", what, lambda: (fused.mm_update(M1, B1), None),
             lambda: (fused.mm_update_plain(M1, B1), None),
             (nbytes(M1) + 2 * fb, 2 * n * nnz(M1)), lambda: M1 @ B1),
            ("mm_update_gram", what, lambda: fused.mm_update_gram(M1, B1),
             lambda: fused.mm_update_gram_plain(M1, B1),
             (nbytes(M1) + 2 * fb + gb, 2 * n * nnz(M1) + sf), None),
            ("mm2_update_gram", what, lambda: fused.mm2_update_gram(M1, B1, M2, B2),
             lambda: fused.mm2_update_gram_plain(M1, B1, M2, B2),
             (nbytes(M1, M2) + 3 * fb + gb, 2 * n * nnz(M1, M2) + sf), None),
            ("px_update", what, lambda: fused.px_update(M1, B1, M2, B2, M3, B3),
             lambda: fused.px_update_plain(M1, B1, M2, B2, M3, B3),
             (nbytes(M1, M2, M3) + 5 * fb, 2 * n * nnz(M1, M2, M3)), None),
        ]
        for name, label, kern, plain, work, library in cases:
            ms = _timed_check(torch, name, label, kern, plain, is_gram, records,
                              work=work, library=library)
            if name == "stencil_spmm_t":
                print(f"[kernel] stencil_spmm_t {what}: {op.nnz / ms / 1e6:.2f} Gnnz/s")
        del op, B1, B2, B3, banded, csr
        torch.cuda.empty_cache()
    return records


def _cbs_nnz(op, exclude_slabs: bool = False) -> int:
    """Structural nonzeros of a const-hop operator: per diagonal, the hop's
    nonzeros times the sites its mask keeps (all sites without a mask);
    ``exclude_slabs`` leaves out the slab-routed diagonals."""
    skip = {s[0] for s in op.slabs} if exclude_slabs else set()
    total = 0
    for d, slot in enumerate(op.mask_slot):
        if d not in skip:
            sites = op.ns if slot < 0 else nnz(op.masks[slot])
            total += nnz(op.hops_all[d]) * sites
    return total


def phase_cbs_kernels(torch, dev, records) -> None:
    """The const-hop kernels against their plain versions at config 4's
    shapes (ns = 32^4, m = 4 * 12): main, main+Gram and both slab forms on
    dirac_cbdia(32), main+Gram on the Z2-gauged operator (value masks, no
    slabs). Then the fused updates at that width (their KMAX = 64 builds) on
    ``I_bs ⊗ C`` coefficients, as the codec expands them. The const-hop
    records take dirac_cbdia's times; every check folds into
    ``records``' max_abs_err."""
    from blockcg_tpu_torch.ops import const_block_stencil as cbs
    from blockcg_tpu_torch.ops import fused
    from blockcg_tpu_torch.problems import dirac_cbdia, dirac_gauged_cbdia

    gen = torch.Generator(device=dev).manual_seed(1)
    op = dirac_cbdia(DIRAC_L, device=dev)
    bs, m, ns = op.bs, op.bs * DIRAC_K, op.ns
    Xm = torch.randn((m, ns), generator=gen, device=dev)
    Ym = torch.randn((m, ns), generator=gen, device=dev)
    Gm = torch.randn((m, m), generator=gen, device=dev)
    main = (op.hops_main, op.main_offsets, op.main_slots, op.masks_main, Xm)
    d, g, nblocks, mul, off, shift = op.slabs[0]
    slab = (op.hops_all[d], g, nblocks, mul, off, shift, Xm)
    Yk, Yp = Ym.clone(), Ym.clone()  # the slab adds in place: one buffer each
    what = f"ns={ns} m={m}"

    def is_gram(w):
        return w.shape == (m, m)

    def slab_case(with_gram):
        """(kern, plain), each from a fresh copy of Ym, for the comparison,
        and the in-place adds alone, for the timing."""
        def kern_t():
            out = cbs.slab_m_accumulate(*slab, Yk, Gm, with_gram=with_gram)
            return out if with_gram else (out, None)

        def plain_t():
            out = cbs.slab_plain(*slab, Yp, Gm, with_gram)
            return out if with_gram else (out, None)

        def kern():
            Yk.copy_(Ym)
            return kern_t()

        def plain():
            Yp.copy_(Ym)
            return plain_t()
        return kern, plain, (kern_t, plain_t)

    # field, Gram bytes; FLOPs of U V^T and of the symmetric Y Y^T
    fb, gb, gf, sf = nbytes(Xm), m * m * 4, 2 * m * m * ns, syrk_flops(m, ns)

    def main_work(o, args, gram=False):
        """Hops, masks, X read once, Y written once; the FLOPs of the
        structural nonzeros of the main kernel's diagonals, and of G = X Y^T
        (2 m^2 a site: not symmetric)."""
        return (nbytes(args[0], args[3]) + 2 * fb + gram * gb,
                2 * DIRAC_K * _cbs_nnz(o, exclude_slabs=True) + gram * gf)

    cols = g * nblocks  # the slab's site columns
    slab_bytes = 3 * (fb // ns) * cols  # X at the sources, Y read and written
    slab_flops = 2 * DIRAC_K * nnz(op.hops_all[d]) * cols
    bsr, why = _site_bsr_library(
        torch, _const_hop_blocks(torch, op.hops_main, op.main_slots, op.masks_main, ns),
        op.main_offsets, Xm, cbs.const_block_stencil_spmm_m_t(*main, op.main_plans))
    _library_note(f"const_block_stencil_spmm_m_t {what} (torch BSR @ dense)", why)
    slab_lib, why = _slab_library(torch, op.hops_all[d], g, nblocks, mul, off, shift, Xm, Ym,
                                  cbs.slab_m_accumulate(*slab, Ym.clone()))
    _library_note(f"slab_m_accumulate {what} (baddbmm_ of H ⊗ I_k on the slab's blocks)", why)
    print(f"[plan] slab_m_accumulate {what}: {_slab_plans(torch, cbs, slab, Ym)}")
    cases = [
        ("const_block_stencil_spmm_m_t", what,
         lambda: (cbs.const_block_stencil_spmm_m_t(*main, op.main_plans), None),
         lambda: cbs.const_block_stencil_plain(*main), None, main_work(op, main), bsr),
        ("const_block_stencil_spmm_m_gram_t", what,
         lambda: cbs.const_block_stencil_spmm_m_gram_t(*main, op.main_plans),
         lambda: cbs.const_block_stencil_plain(*main, True), None, main_work(op, main, True),
         None),
        ("slab_m_accumulate", what, *slab_case(False), (slab_bytes, slab_flops), slab_lib),
        # With the Gram: X at the destinations too, G read and written.
        ("slab_m_accumulate", what + " with Gram", *slab_case(True),
         (slab_bytes + (fb // ns) * cols + 2 * gb, slab_flops + 2 * m * m * cols), None),
    ]
    for name, label, kern, plain, timed, work, library in cases:
        _timed_check(torch, name, label, kern, plain, is_gram, records, timed, work=work,
                     library=library)
    print(f"[plan] const_block_stencil_spmm_m_t and _m_gram_t {what}: {_cbs_plans(op, Xm)}")
    del bsr
    apply_ms = median_ms(torch, lambda: op.matmat_t(Xm))
    print(f"[kernel] dirac_cbdia({DIRAC_L}).matmat_t on the merged field: {apply_ms:.4f} ms, "
          f"{op.nnz / apply_ms / 1e6:.2f} Gnnz/s (nnz {op.nnz})")
    del op, main, slab, Yk, Yp
    gop = dirac_gauged_cbdia(DIRAC_L, device=dev)
    gmain = (gop.hops_main, gop.main_offsets, gop.main_slots, gop.masks_main, Xm)
    _timed_check(torch, "const_block_stencil_spmm_m_gram_t",
                 f"{what} gauged Z2 value masks",
                 lambda: cbs.const_block_stencil_spmm_m_gram_t(*gmain, gop.main_plans),
                 lambda: cbs.const_block_stencil_plain(*gmain, True), is_gram, records,
                 work=main_work(gop, gmain, True))
    del gop, gmain

    eye = torch.eye(bs, device=dev)
    M1, M2, M3 = (torch.kron(eye, torch.randn((DIRAC_K, DIRAC_K), generator=gen, device=dev)
                             / DIRAC_K ** 0.5) for _ in range(3))
    Zm = torch.randn((m, ns), generator=gen, device=dev)
    what = f"{what} I_{bs}⊗C"
    cases = [
        ("gram", lambda: (None, fused.gram(Xm, Ym)),
         lambda: (None, fused.gram_plain(Xm, Ym)), (2 * fb + gb, gf), lambda: Xm @ Ym.T),
        ("mm_update", lambda: (fused.mm_update(M1, Xm), None),
         lambda: (fused.mm_update_plain(M1, Xm), None),
         (nbytes(M1) + 2 * fb, 2 * ns * nnz(M1)), lambda: M1 @ Xm),
        ("mm_update_gram", lambda: fused.mm_update_gram(M1, Xm),
         lambda: fused.mm_update_gram_plain(M1, Xm),
         (nbytes(M1) + 2 * fb + gb, 2 * ns * nnz(M1) + sf), None),
        ("mm2_update_gram", lambda: fused.mm2_update_gram(M1, Xm, M2, Ym),
         lambda: fused.mm2_update_gram_plain(M1, Xm, M2, Ym),
         (nbytes(M1, M2) + 3 * fb + gb, 2 * ns * nnz(M1, M2) + sf), None),
        ("px_update", lambda: fused.px_update(M1, Xm, M2, Ym, M3, Zm),
         lambda: fused.px_update_plain(M1, Xm, M2, Ym, M3, Zm),
         (nbytes(M1, M2, M3) + 5 * fb, 2 * ns * nnz(M1, M2, M3)), None),
    ]
    for name, kern, plain, work, library in cases:
        _timed_check(torch, name, what, kern, plain, is_gram, records, work=work,
                     library=library)
    # Row 7 on the (k, bs, ns) view with k x k coefficients and A, as the
    # distributed per-site operator hands its fields over.
    C = torch.randn((DIRAC_K, DIRAC_K), generator=gen, device=dev) / DIRAC_K ** 0.5
    Xv, Yv = Xm.view(DIRAC_K, bs, ns), Ym.view(DIRAC_K, bs, ns)
    _timed_check(torch, "mm_update_gram", f"({DIRAC_K}, {bs}, {ns}) view with A",
                 lambda: fused.mm_update_gram(C, Xv, Yv),
                 lambda: fused.mm_update_gram_plain(C, Xv, Yv),
                 lambda w: w.shape == (DIRAC_K, DIRAC_K), records,
                 work=(nbytes(C) + 3 * fb + 4 * DIRAC_K ** 2,
                       2 * ns * bs * DIRAC_K ** 2 + syrk_flops(DIRAC_K, bs * ns)))
    del Xm, Ym, Zm, Xv, Yv
    torch.cuda.empty_cache()


def phase_krylov_kernels(torch, dev, records) -> None:
    """``xr_update_gram`` and ``qr_p_update`` against their plain versions at
    config 2's width (k = 16, n = 512^2) and config 4's (m = 48 on
    ``I_4 ⊗ C``, ns = 32^4), each into fresh buffers and in place (donated,
    from a fresh copy of the inputs for the comparison). The records take
    each kernel's times on its own path's width: config 2 for
    ``xr_update_gram`` (BCG), config 4 for ``qr_p_update`` (shifted block)."""
    from blockcg_tpu_torch.ops import fused

    gen = torch.Generator(device=dev).manual_seed(2)

    def is_gram(w):
        return w.shape[0] == w.shape[1]

    def coeff(k, bs):
        C = torch.randn((k, k), generator=gen, device=dev) / k ** 0.5
        return torch.kron(torch.eye(bs, device=dev), C)

    def both_ways(name, fn, plain, args, donated, what, work):
        def fresh():
            return fn(*args)

        def want():
            return plain(*args)
        _timed_check(torch, name, f"{what} fresh", fresh, want, is_gram, records, work=work)
        bufs = list(args)
        for i in donated:
            bufs[i] = args[i].clone()

        def in_place():
            return fn(*bufs, donate=True)

        def kern():
            for i in donated:
                bufs[i].copy_(args[i])
            return in_place()
        _timed_check(torch, name, f"{what} in place", kern, want, is_gram, records,
                     timed=(in_place, want), work=work)

    def operands(k, bs, n):
        m = bs * k
        what = f"ns={n} m={m} I_{bs}⊗C" if bs > 1 else f"n={n} k={k}"
        A, M = coeff(k, bs), coeff(k, bs)
        F = [torch.randn((m, n), generator=gen, device=dev) for _ in range(4)]
        fb = nbytes(F[0])
        # xr: P, X, Z, R read, Xn, Rn and G written; qr: Q1, P read, Q, Pn written.
        xr_work = (nbytes(A) + 6 * fb + m * m * 4, 4 * n * nnz(A) + syrk_flops(m, n))
        qr_work = (nbytes(A, M) + 4 * fb, 2 * n * nnz(A, M))
        return {"xr_update_gram": (fused.xr_update_gram, fused.xr_update_gram_plain,
                                   (A, *F), (2, 4), what, xr_work),
                "qr_p_update": (fused.qr_p_update, fused.qr_p_update_plain,
                                (A, F[0], M, F[1]), (1, 3), what, qr_work)}

    config4, config2 = operands(DIRAC_K, 4, DIRAC_L ** 4), operands(16, 1, 512 ** 2)
    for m in (4 * DIRAC_K, 16):
        print(f"[plan] qr_p_update m={m}: {fused.qr_p_update_plan(m, dev)}")
        print(f"[plan] xr_update_gram m={m}: {fused.xr_update_gram_plan(m, dev)}")
    # Each kernel's own path first: its first check sets its record's times.
    for cases, name in ((config4, "qr_p_update"), (config2, "xr_update_gram"),
                        (config4, "xr_update_gram"), (config2, "qr_p_update")):
        both_ways(name, *cases[name])
    del config4, config2
    torch.cuda.empty_cache()


def true_relres(torch, op, X, B, sigma: float = 0.0, op64=None) -> float:
    """max_j ||B e_j - (A + sigma I) X e_j|| / ||B e_j||, in f64 (complex128
    for complex fields) on the card."""
    from blockcg_tpu_torch.operators import astype

    wide = torch.complex128 if B.is_complex() else torch.float64
    B64, X64 = B.to(wide), X.to(wide)
    op64 = astype(op, wide) if op64 is None else op64
    R = B64 - op64.matmat(X64) - sigma * X64
    return float((torch.linalg.vector_norm(R, dim=0)
                  / torch.linalg.vector_norm(B64, dim=0)).max())


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_config3(torch, dev) -> None:
    from blockcg_tpu_torch import solve_sbcgrq
    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.problems import config3_sbcgrq_3d_64

    op, B, meta = config3_sbcgrq_3d_64(device=dev)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X, info = solve_sbcgrq(op, B, tol=1e-6, qr_passes=1)
        torch.cuda.synchronize()
        runs.append((X, info, time.perf_counter() - t0))
        if _ == 0:
            missing = [w for w in CONFIG3_WRAPPERS if _native.launches[w] == 0]
            if missing:
                raise AssertionError(f"config 3 did not launch the kernels of {missing}")
    (X1, info, s1), (X2, info2, s2) = runs
    if not bool(info.converged.all()):
        raise AssertionError(f"config 3 did not converge: {info}")
    rel = true_relres(torch, op, X1, B)
    if not rel <= 1e-5:
        raise AssertionError(f"config 3 true relres {rel:.3e} > 1e-5")
    if not torch.equal(X1, X2):
        raise AssertionError("config 3 repeat solve is not bitwise identical")
    counts = {w: _native.launches[w] for w in CONFIG3_WRAPPERS}
    print(f"[config3] {meta['name']} n={op.n} k={B.shape[1]}: {info.iterations} iterations, "
          f"{s1:.3f} s (repeat {s2:.3f} s, {info2.iterations} iterations, bitwise identical), "
          f"true relres {rel:.3e}, launches after first solve {counts}")


def phase_north_star(torch, dev) -> None:
    from blockcg_tpu_torch import solve_refined, solve_sbcgrq
    from blockcg_tpu_torch.problems import laplacian_dia
    from blockcg_tpu_torch.problems.presets import _rhs

    op = laplacian_dia(SHAPES[0], device=dev)
    B = _rhs(op.n, K, torch.float32, device=dev)
    for qr_passes in (1, 2):
        inner = []

        def solve_fn(o, r, t):
            X, info = solve_sbcgrq(o, r, tol=t, max_iter=2000, qr_passes=qr_passes)
            inner.append(info.iterations)
            return X, info

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        X, info = solve_refined(op, B, tol=1e-10, inner_tol=3e-6, solve_fn=solve_fn)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rel = true_relres(torch, op, X, B)
        if not (bool(info.converged.all()) and rel <= 1e-10):
            raise AssertionError(f"north star (qr_passes={qr_passes}) reached "
                                 f"true relres {rel:.3e}, not 1e-10: {info}")
        print(f"[northstar] 128^3 n={op.n} k={K} tol=1e-10 inner_tol=3e-6 "
              f"qr_passes={qr_passes}: {info.iterations} cycles, {sum(inner)} inner "
              f"iterations {inner}, {secs:.3f} s, true relres {rel:.3e}, "
              f"peak {peak:.2f} GiB")
        del X


def phase_config4(torch, dev) -> None:
    """Config 4 through the entry points: SBCGrQ at tol 1e-6 twice (bitwise
    identical), then ``solve_refined`` to 1e-10 on the same operator (its f64
    outer apply runs the plain route)."""
    from blockcg_tpu_torch import solve_refined, solve_sbcgrq
    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.problems import config4_dirac_32

    op, B, meta = config4_dirac_32(L=DIRAC_L, device=dev)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X, info = solve_sbcgrq(op, B, tol=1e-6, qr_passes=1)
        torch.cuda.synchronize()
        runs.append((X, info, time.perf_counter() - t0))
    (X1, info, s1), (X2, info2, s2) = runs
    if not bool(info.converged.all()):
        raise AssertionError(f"config 4 did not converge: {info}")
    print(f"[config4] {_slab_launches(_native, op)}")
    rel = true_relres(torch, op, X1, B)
    if not rel <= 1e-5:
        raise AssertionError(f"config 4 true relres {rel:.3e} > 1e-5")
    if not torch.equal(X1, X2):
        raise AssertionError("config 4 repeat solve is not bitwise identical")
    print(f"[config4] {meta['name']} n={op.n} nnz={op.nnz} k={B.shape[1]}: "
          f"{info.iterations} iterations (reference {DIRAC_REF_ITERS}), {s1:.3f} s "
          f"(repeat {s2:.3f} s, {info2.iterations} iterations, bitwise identical), "
          f"true relres {rel:.3e}, launches {dict(_native.launches)}")
    del X1, X2, runs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    X, rinfo = solve_refined(op, B, tol=1e-10, inner_tol=3e-6, qr_passes=1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rel = true_relres(torch, op, X, B)
    if not (bool(rinfo.converged.all()) and rel <= 1e-10):
        raise AssertionError(f"config 4 solve_refined reached true relres {rel:.3e}, "
                             f"not 1e-10: {rinfo}")
    print(f"[config4] solve_refined tol=1e-10 inner_tol=3e-6 qr_passes=1: "
          f"{rinfo.iterations} cycles, {rinfo.matvecs} matvecs, {secs:.3f} s, "
          f"true relres {rel:.3e}, peak {peak:.2f} GiB")


def phase_config12(torch, dev) -> None:
    """Configs 1 and 2 through the entry points: CG per column on config 1;
    on config 2 BCG (twice, bitwise identical), BCGA, BCGdQ, CG on the first
    column (the per-RHS comparison config 2 is defined by) and
    ``solve_refined(inner_solver="bcg")`` to 1e-10. The solvers report their
    recurrence's monitor; the true f64 residual is printed beside it, and
    bounded for config 1 (``CG1_TRUE_RELRES``) and the refined solve."""
    from blockcg_tpu_torch import (
        solve_bcg,
        solve_bcga,
        solve_bcgdq,
        solve_cg,
        solve_refined,
    )
    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.problems import config1_cg_2d_128, config2_bcg_2d_512

    op, B, meta = config1_cg_2d_128(device=dev)
    for j in range(B.shape[1]):
        (x, info), secs = _timed(torch, lambda: solve_cg(op, B[:, j], tol=1e-6, max_iter=5000))
        rel = true_relres(torch, op, x[:, None], B[:, j:j + 1])
        if not (bool(info.converged.all()) and rel <= CG1_TRUE_RELRES):
            raise AssertionError(f"config 1 column {j}: true relres {rel:.3e}, {info}")
        print(f"[config1] {meta['name']} n={op.n} column {j}: solve_cg {info.iterations} "
              f"iterations, {secs:.3f} s, monitor relres {float(info.relres[0]):.3e}, "
              f"true relres {rel:.3e}")

    op, B, meta = config2_bcg_2d_512(device=dev)
    _native.reset_launches()
    (X1, info), s1 = _timed(torch, lambda: solve_bcg(op, B, tol=1e-6, max_iter=5000))
    if _native.launches["xr_update_gram"] == 0:
        raise AssertionError("config 2's BCG never launched xr_update_gram")
    (X2, info2), s2 = _timed(torch, lambda: solve_bcg(op, B, tol=1e-6, max_iter=5000))
    if not torch.equal(X1, X2) or info2.iterations != info.iterations:
        raise AssertionError("config 2 repeat BCG solve is not bitwise identical")
    del X2
    runs = [("solve_bcg", X1, info, s1)]
    for name, fn in (("solve_bcga", solve_bcga), ("solve_bcgdq qr_passes=1", solve_bcgdq)):
        (X, inf), secs = _timed(torch, lambda: fn(op, B, tol=1e-6, max_iter=5000))
        runs.append((name, X, inf, secs))
    for name, X, inf, secs in runs:
        if not bool(inf.converged.all()):
            raise AssertionError(f"config 2 {name} did not converge: {inf}")
        print(f"[config2] {meta['name']} n={op.n} k={B.shape[1]} {name}: {inf.iterations} "
              f"iterations, {secs:.3f} s, monitor relres {float(inf.relres.max()):.3e}, "
              f"true relres {true_relres(torch, op, X, B):.3e}"
              + (f" (repeat {s2:.3f} s, bitwise identical)" if name == "solve_bcg" else ""))
    del runs, X1, X
    (x, info), secs = _timed(torch, lambda: solve_cg(op, B[:, 0], tol=1e-6, max_iter=5000))
    if not bool(info.converged.all()):
        raise AssertionError(f"config 2 CG on column 0 did not converge: {info}")
    print(f"[config2] solve_cg on column 0: {info.iterations} iterations, {secs:.3f} s, "
          f"monitor relres {float(info.relres.max()):.3e}, "
          f"true relres {true_relres(torch, op, x[:, None], B[:, :1]):.3e}")
    torch.cuda.reset_peak_memory_stats()
    (X, info), secs = _timed(torch, lambda: solve_refined(op, B, tol=1e-10, inner_solver="bcg"))
    rel = true_relres(torch, op, X, B)
    if not (bool(info.converged.all()) and rel <= 1e-10):
        raise AssertionError(f"config 2 solve_refined(bcg) reached true relres {rel:.3e}: {info}")
    print(f"[config2] solve_refined tol=1e-10 inner_solver=bcg: {info.iterations} cycles, "
          f"{info.matvecs} matvecs, {secs:.3f} s, true relres {rel:.3e}, "
          f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")


def phase_config4_shifted(torch, dev) -> None:
    """The multi-shift solvers on config 4 with ``SHIFTS``: the shifted-block
    SBCGrQ on the 12 RHS, shifted CG on the first column; every shift's true
    f64 residual of ``(A + sigma I) X - B`` at most 1e-5."""
    from blockcg_tpu_torch import solve_shifted_cg, solve_shifted_sbcgrq
    from blockcg_tpu_torch.operators import astype
    from blockcg_tpu_torch.problems import config4_dirac_32

    op, B, meta = config4_dirac_32(L=DIRAC_L, device=dev)
    op64 = astype(op, torch.float64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (Xs, info), secs = _timed(torch, lambda: solve_shifted_sbcgrq(op, B, SHIFTS, tol=1e-6))
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    rels = [true_relres(torch, op, Xs[j], B, s, op64) for j, s in enumerate(SHIFTS)]
    if not (bool(info.converged.all()) and max(rels) <= 1e-5):
        raise AssertionError(f"config 4 shifted block: true relres {rels}, {info}")
    print(f"[shifted] {meta['name']} n={op.n} k={B.shape[1]} shifts {SHIFTS}: "
          f"solve_shifted_sbcgrq {info.iterations} iterations, {secs:.3f} s, true relres "
          f"{['%.3e' % r for r in rels]}, peak {peak:.2f} GiB above the operator and B")
    del Xs
    (X, info), secs = _timed(torch, lambda: solve_shifted_cg(op, B[:, 0], SHIFTS, tol=1e-6))
    rels = [true_relres(torch, op, X[:, j:j + 1], B[:, :1], s, op64)
            for j, s in enumerate(SHIFTS)]
    if not (bool(info.converged.all()) and max(rels) <= 1e-5):
        raise AssertionError(f"config 4 shifted CG: true relres {rels}, {info}")
    print(f"[shifted] solve_shifted_cg on column 0: {info.iterations} iterations, "
          f"{secs:.3f} s, true relres {['%.3e' % r for r in rels]}")


def _bs_kernel_checks(torch, records, blocks, offsets, k, label, seed) -> None:
    """The three block-stencil wrappers against their plain versions on the
    per-site ``blocks`` of a built operator with k right-hand sides: merged
    with and without the Gram (m = bs * k), and the (k, bs, ns) view; then
    the merged apply's rate in structural nonzeros."""
    from blockcg_tpu_torch.ops import block_stencil as bsk

    _, bs, _, ns = blocks.shape
    m = bs * k
    gen = torch.Generator(device=blocks.device).manual_seed(seed)
    Xm = torch.randn((m, ns), generator=gen, device=blocks.device)
    Xv = torch.randn((k, bs, ns), generator=gen, device=blocks.device)
    # Every block read once (zeros too), X read once, Y written once; the
    # FLOPs of the nonzero coefficients; the Gram adds G and m (m + 1) ns.
    nzb = nnz(blocks)
    apply_work = (nbytes(blocks, Xm, Xm), 2 * k * nzb)
    gram_work = (apply_work[0] + m * m * 4, apply_work[1] + syrk_flops(m, ns))

    def is_gram(w):
        return w.shape == (m, m)
    what = f"{label} ns={ns} bs={bs} k={k} m={m}"
    bsr, why = _site_bsr_library(torch, blocks, offsets, Xm,
                                 bsk.block_stencil_spmm_m_t(blocks, offsets, Xm))
    _library_note(f"block_stencil_spmm_m_t {what} (torch BSR @ dense)", why)
    ms = _timed_check(torch, "block_stencil_spmm_m_t", what,
                      lambda: (bsk.block_stencil_spmm_m_t(blocks, offsets, Xm), None),
                      lambda: bsk.block_stencil_plain(blocks, offsets, Xm),
                      is_gram, records, work=apply_work, library=bsr)
    gms = _timed_check(torch, "block_stencil_spmm_m_gram_t", what,
                       lambda: bsk.block_stencil_spmm_m_gram_t(blocks, offsets, Xm),
                       lambda: bsk.block_stencil_plain(blocks, offsets, Xm, True),
                       is_gram, records, work=gram_work)
    bsr, why = _site_bsr_library(torch, blocks, offsets, Xv,
                                 bsk.block_stencil_spmm_t(blocks, offsets, Xv))
    _library_note(f"block_stencil_spmm_t {label} view (torch BSR @ dense)", why)
    vms = _timed_check(torch, "block_stencil_spmm_t", f"{label} ({k}, {bs}, {ns}) view",
                       lambda: (bsk.block_stencil_spmm_t(blocks, offsets, Xv), None),
                       lambda: (bsk.block_stencil_v_plain(blocks, offsets, Xv), None),
                       is_gram, records, work=apply_work, library=bsr)
    del bsr
    for label_, gram in (("merged", False), ("merged with Gram", True)):
        plans = bsk.launch_plans(blocks, offsets, k, gram, blocks.device)
        print(f"[kernel] block stencil plan {what} {label_}: " +
              "; ".join(f"RHS {j0}:{j1} {plan.describe()}" for (j0, j1), plan in plans))
    print(f"[kernel] block stencil {what}: merged {nzb / ms / 1e6:.2f}, with Gram "
          f"{nzb / gms / 1e6:.2f}, (k, bs, ns) view {nzb / vms / 1e6:.2f} Gnnz/s "
          f"(nnz {nzb} of the blocks)")


def phase_matrixlink(torch, dev, records) -> dict:
    """The matrix-link lattice operator ``dirac_gauged_matrix(32, m=0.5)`` in
    the per-site block container with 12 RHS from ``default_rng(1234)``, as
    the reference's ``bench.py`` builds it: first the block-stencil kernels
    against their plain versions on its blocks, then, with the launch counts
    set to 0, ``solve_sbcgrq`` at tol 1e-6 twice (bitwise identical, true
    relres <= 1e-5), the public f32 ``op(X)`` and ``solve_refined`` to 1e-10.
    Returns the launch counts of the solves."""
    from blockcg_tpu_torch import solve_refined, solve_sbcgrq
    from blockcg_tpu_torch.operators import astype
    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.problems import dirac_gauged_matrix

    op, build_s = _timed(torch, lambda: dirac_gauged_matrix(ML_L, m=0.5, device=dev))
    print(f"[matrixlink] dirac_gauged_matrix({ML_L}) n={op.n} nnz={op.nnz} "
          f"offsets {len(op.offsets)}: built in {build_s:.1f} s")
    _bs_kernel_checks(torch, records, op.blocks, op.offsets, ML_K,
                      f"dirac_gauged_matrix({ML_L})", 3)
    rng = np.random.default_rng(ML_SEED)
    B = torch.as_tensor(rng.standard_normal((ML_K, op.n)), dtype=torch.float32,
                        device=dev).T.contiguous()
    op64 = astype(op, torch.float64)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _native.reset_launches()
    runs = [_timed(torch, lambda: solve_sbcgrq(op, B, tol=1e-6, qr_passes=1)) for _ in range(2)]
    ((X1, info), s1), ((X2, info2), s2) = runs
    Y32 = op(X1)  # the public f32 apply, on the flat field
    (X, rinfo), rs = _timed(torch, lambda: solve_refined(op, B, tol=1e-10, inner_tol=3e-6,
                                                         qr_passes=1, op64=op64))
    counts = dict(_native.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rel = true_relres(torch, op, X1, B, op64=op64)
    rel32 = float((torch.linalg.vector_norm(B - Y32, dim=0)
                   / torch.linalg.vector_norm(B, dim=0)).max())
    if not (bool(info.converged.all()) and rel <= 1e-5):
        raise AssertionError(f"matrix link: true relres {rel:.3e} > 1e-5: {info}")
    if not torch.equal(X1, X2):
        raise AssertionError("matrix link: repeat solve is not bitwise identical")
    print(f"[matrixlink] solve_sbcgrq k={ML_K} tol=1e-6 qr_passes=1: {info.iterations} "
          f"iterations, {s1:.3f} s (repeat {s2:.3f} s, {info2.iterations} iterations, bitwise "
          f"identical), true relres {rel:.3e} (f32 op(X): {rel32:.3e})")
    rrel = true_relres(torch, op, X, B, op64=op64)
    if not (bool(rinfo.converged.all()) and rrel <= 1e-10):
        raise AssertionError(f"matrix link solve_refined reached {rrel:.3e}, not 1e-10: {rinfo}")
    print(f"[matrixlink] solve_refined tol=1e-10 inner_tol=3e-6 qr_passes=1: "
          f"{rinfo.iterations} cycles, {rinfo.matvecs} matvecs, {rs:.3f} s, true relres "
          f"{rrel:.3e}; peak {peak:.2f} GiB; launches {counts}")
    return counts


def phase_bdia_config4(torch, dev) -> None:
    """``dirac_bdia(32)`` holds config 4's matrix in the per-site container:
    SBCGrQ on config 4's B within one iteration of the const-hop solve, and
    the same X to the solve's own accuracy."""
    from blockcg_tpu_torch import solve_sbcgrq
    from blockcg_tpu_torch.problems import config4_dirac_32, dirac_bdia

    cop, B, _ = config4_dirac_32(L=DIRAC_L, device=dev)
    (Xc, ic), sc = _timed(torch, lambda: solve_sbcgrq(cop, B, tol=1e-6, qr_passes=1))
    del cop
    torch.cuda.empty_cache()
    bop, build_s = _timed(torch, lambda: dirac_bdia(DIRAC_L, device=dev))
    (Xb, ib), sb = _timed(torch, lambda: solve_sbcgrq(bop, B, tol=1e-6, qr_passes=1))
    rel = true_relres(torch, bop, Xb, B)
    dx = relfro(Xb, Xc)
    if not (bool(ib.converged.all()) and abs(ib.iterations - ic.iterations) <= 1
            and rel <= 1e-5 and dx <= BDIA_X_RTOL):
        raise AssertionError(f"dirac_bdia({DIRAC_L}): {ib.iterations} iterations against the "
                             f"const-hop {ic.iterations}, true relres {rel:.3e}, "
                             f"|Xb - Xc| / |Xc| {dx:.3e}")
    print(f"[bdia-config4] dirac_bdia({DIRAC_L}) (built in {build_s:.1f} s, nnz {bop.nnz}): "
          f"{ib.iterations} iterations, {sb:.3f} s; const-hop config 4: {ic.iterations} "
          f"iterations, {sc:.3f} s; |Xb - Xc| / |Xc| {dx:.3e}, true relres {rel:.3e}")


def phase_complex(torch, dev, records) -> None:
    """Complex Hermitian systems with 6 RHS through their realified
    operators: the matrix-link ``realify(dirac_gauged_matrix(L,
    complex64))`` (the block-stencil kernels at bs = 8, k = 6 first checked
    against their plain versions on its real core) and the U(1)
    ``dirac_gauged_cbdia(32, complex64)`` (a const-hop core at bs = 8).
    ``solve_sbcgrq`` at tol 1e-6; true relres <= 1e-5 by the operator's
    complex128 copy on the card."""
    from blockcg_tpu_torch import realify, solve_sbcgrq
    from blockcg_tpu_torch.problems import dirac_gauged_cbdia, dirac_gauged_matrix

    builds = (
        (f"realify(dirac_gauged_matrix({COMPLEX_ML_L}, complex64))", lambda: realify(
            dirac_gauged_matrix(COMPLEX_ML_L, m=0.5, dtype=torch.complex64, device=dev))),
        (f"dirac_gauged_cbdia({DIRAC_L}, complex64)",
         lambda: dirac_gauged_cbdia(DIRAC_L, m=0.5, dtype=torch.complex64, device=dev)),
    )
    for i, (label, build) in enumerate(builds):
        rop, build_s = _timed(torch, build)
        if i == 0:
            _bs_kernel_checks(torch, records, rop.real_op.blocks, rop.real_op.offsets,
                              COMPLEX_K, "realified matrix link", 4)
        rng = np.random.default_rng(ML_SEED + 1 + i)
        Bc = rng.standard_normal((rop.n, COMPLEX_K)) + 1j * rng.standard_normal((rop.n, COMPLEX_K))
        B = torch.as_tensor(Bc, dtype=torch.complex64, device=dev)
        (X, info), secs = _timed(torch, lambda: solve_sbcgrq(rop, B, tol=1e-6, qr_passes=1))
        rel = true_relres(torch, rop, X, B)
        if not (X.dtype == torch.complex64 and bool(info.converged.all()) and rel <= 1e-5):
            raise AssertionError(f"{label}: {X.dtype}, true relres {rel:.3e}: {info}")
        print(f"[complex] {label} n={rop.n} (real core bs={rop.real_op.bs}, "
              f"{len(rop.real_op.offsets)} diagonals, built in {build_s:.1f} s) k={COMPLEX_K}: "
              f"solve_sbcgrq {info.iterations} iterations, {secs:.3f} s, true relres {rel:.3e}")
        del rop, X, B
        torch.cuda.empty_cache()

def phase_cheb_kernel(torch, dev, records) -> None:
    """``cheb_step`` against its plain version at the Chebyshev path's widths:
    (32, 2,097,152) (128^3, k = 32) and config 4's merged (48, 32^4), into
    fresh buffers and in place (donated, from a fresh copy of Z and D for
    the comparison). The record takes the first shape's times."""
    from blockcg_tpu_torch.ops import fused

    gen = torch.Generator(device=dev).manual_seed(5)
    c1, c2 = 0.6180339, -0.2345678
    for shape in CHEB_STEP_SHAPES:
        R, Z, D, AZ = (torch.randn(shape, generator=gen, device=dev) for _ in range(4))
        work = (6 * nbytes(R), 5 * R.numel())  # 4 fields read, 2 written
        what = f"{shape}"
        _timed_check(torch, "cheb_step", f"{what} fresh",
                     lambda: fused.cheb_step(R, Z, D, AZ, c1, c2),
                     lambda: fused.cheb_step_plain(R, Z, D, AZ, c1, c2),
                     lambda w: False, records, work=work, rtol=CHEB_RTOL)
        Zk, Dk = Z.clone(), D.clone()

        def in_place():
            return fused.cheb_step(R, Zk, Dk, AZ, c1, c2, donate=True)

        def kern():
            Zk.copy_(Z)
            Dk.copy_(D)
            return in_place()
        _timed_check(torch, "cheb_step", f"{what} in place", kern,
                     lambda: fused.cheb_step_plain(R, Z, D, AZ, c1, c2),
                     lambda w: False, records,
                     timed=(in_place, lambda: fused.cheb_step_plain(R, Z, D, AZ, c1, c2)),
                     work=work, rtol=CHEB_RTOL)
        got = fused.cheb_step(R, Z, D, AZ, c1, c2)
        want = fused.cheb_step_plain(R, Z, D, AZ, c1, c2)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"cheb_step {what}: not bitwise equal to the plain version")
        print(f"[kernel] cheb_step {what}: bitwise equal to the plain version")
        del R, Z, D, AZ, Zk, Dk, got, want
        torch.cuda.empty_cache()


def _view_main_work(op, k, gram=False):
    """Row 14 (and 15) on the (k, bs, ns) view of ``op``'s main diagonals:
    hops, the streamed mask rows, X read once, Y written once; the FLOPs of
    the structural nonzeros; the Gram adds (k, k) and 2 k^2 bs ns."""
    fb = 4 * op.bs * k * op.ns
    main = (op.hops_main,) + (() if op.masks_main is None else (op.masks_main,))
    return (nbytes(*main) + 2 * fb + gram * 4 * k * k,
            2 * k * _cbs_nnz(op, exclude_slabs=True) + gram * 2 * k * k * op.bs * op.ns)


def phase_view_kernels(torch, dev, records) -> None:
    """The (k, bs, ns) const-hop kernels against their plain versions: first
    at the even-odd CG's shape, one RHS on a parity hop of dirac_eo(32)
    (524,288 sites; its records), then on config 4's operator at (1, 4,
    32^4) and (12, 4, 32^4); with and without the Gram; the slab add on each
    operator's slabs, in place. Then the k = 1 route through rows 14 and 18
    against the merged kernels (rows 16 and 19): the same bits."""
    from blockcg_tpu_torch.ops import const_block_stencil as cbs
    from blockcg_tpu_torch.problems import dirac_cbdia, dirac_eo

    gen = torch.Generator(device=dev).manual_seed(6)
    eo = dirac_eo(DIRAC_L, device=dev)
    op4 = dirac_cbdia(DIRAC_L, device=dev)
    for label, op, k in ((f"dirac_eo({DIRAC_L}) hop_oe", eo.hop_oe, 1),
                         ("config 4", op4, 1), ("config 4", op4, DIRAC_K)):
        Xv = torch.randn((k, op.bs, op.ns), generator=gen, device=dev)
        Yv = torch.randn((k, op.bs, op.ns), generator=gen, device=dev)
        main = (op.hops_main, op.main_offsets, op.main_slots, op.masks_main, Xv)
        what = f"{label} ({k}, {op.bs}, {op.ns})"

        def is_gram(w, k=k):
            return w.shape == (k, k)
        bsr, why = _site_bsr_library(
            torch, _const_hop_blocks(torch, op.hops_main, op.main_slots, op.masks_main, op.ns),
            op.main_offsets, Xv, cbs.const_block_stencil_spmm_t(*main))
        _library_note(f"const_block_stencil_spmm_t {what} (torch BSR @ dense)", why)
        _timed_check(torch, "const_block_stencil_spmm_t", what,
                     lambda: (cbs.const_block_stencil_spmm_t(*main, op.main_plans), None),
                     lambda: cbs.const_block_stencil_v_plain(*main), is_gram, records,
                     work=_view_main_work(op, k), library=bsr)
        del bsr
        plan = op.main_plans.get(op.main_offsets, op.masks_main.shape[0], k, op.ns, dev,
                                 view=True)
        print(f"[plan] const_block_stencil_spmm_t {what}: cm_spmm {plan.describe()}")
        if k > 1:  # the view's launch beside the merged one (row 16) on the same field
            Xm = Xv.transpose(0, 1).reshape(op.bs * k, op.ns).contiguous()
            vms = median_ms(torch, lambda: cbs.const_block_stencil_spmm_t(*main, op.main_plans))
            mms = median_ms(torch, lambda: cbs.const_block_stencil_spmm_m_t(
                *main[:4], Xm, op.main_plans))
            print(f"[kernel] const_block_stencil_spmm_t {what}: {vms:.4f} ms on the view "
                  f"(ungrouped), const_block_stencil_spmm_m_t {mms:.4f} ms on the merged field "
                  "(row 16, grouped)")
            del Xm
        _timed_check(torch, "const_block_stencil_spmm_gram_t", what,
                     lambda: cbs.const_block_stencil_spmm_gram_t(*main),
                     lambda: cbs.const_block_stencil_v_plain(*main, True), is_gram, records,
                     work=_view_main_work(op, k, True))
        for d, g, nblocks, mul, off, shift in op.slabs[:1]:
            slab = (op.hops_all[d], g, nblocks, mul, off, shift, Xv)
            Yk, Yp = Yv.clone(), Yv.clone()
            cols = g * nblocks
            library = None
            if k == 1:  # one RHS: the merged form's baddbmm_ on the same memory (W = H)
                flat = (op.bs, op.ns)
                library, why = _slab_library(
                    torch, *slab[:-1], Xv.view(flat), Yv.view(flat),
                    cbs.slab_block_accumulate(*slab, Yv.clone()).view(flat))
                _library_note(f"slab_block_accumulate {what} (baddbmm_ on the slab's blocks)",
                              why)
            _timed_check(torch, "slab_block_accumulate", f"{what} slab g={g} x {nblocks}",
                         lambda: (Yk.copy_(Yv), cbs.slab_block_accumulate(*slab, Yk))[1:],
                         lambda: (Yp.copy_(Yv), cbs.slab_v_plain(*slab, Yp))[1:],
                         is_gram, records,
                         timed=(lambda: cbs.slab_block_accumulate(*slab, Yk),
                                lambda: cbs.slab_v_plain(*slab, Yp)),
                         work=(3 * 4 * op.bs * k * cols, 2 * k * nnz(op.hops_all[d]) * cols),
                         library=library)
        del Xv, Yv, main
    for label, op in (("config 4", op4), (f"dirac_eo({DIRAC_L}) hop_oe", eo.hop_oe),
                      (f"dirac_eo({DIRAC_L}) hop_eo", eo.hop_eo)):
        x = torch.randn((op.bs, op.ns), generator=gen, device=dev)
        y, ym = op.matmat_t(x), op._apply_m(x, False)[0]
        torch.cuda.synchronize()
        if not torch.equal(y, ym):
            raise AssertionError(f"{label}: the k = 1 route through rows 14 and 18 differs "
                                 f"from the merged kernels by {relmax(y, ym):.3e}")
        print(f"[kernel] {label} k = 1: the (k, bs, ns) route gives the merged kernels' "
              f"bits ({len(op.main_offsets)} main diagonals, {len(op.slabs)} slabs)")
    del eo, op4
    torch.cuda.empty_cache()


def _scaled_laplacian(torch, dev, seed: int = 0):
    """``D A D``: the 128^3 Dirichlet Laplacian with rows and columns scaled
    by ``D = diag(exp(0.5 g))``, g ~ N(0, 1) from ``default_rng(seed)``, as
    DIA diagonals built on the host (entries scaled over about two decades
    each way): the system Jacobi preconditioning is for."""
    from blockcg_tpu_torch.operators import DIAOperator
    from blockcg_tpu_torch.problems.laplacian import _laplacian_bands

    offsets, diags = _laplacian_bands(PRECOND_SHAPE, np.float64)
    n = diags.shape[1]
    s = np.exp(0.5 * np.random.default_rng(seed).standard_normal(n))
    i = np.arange(n)
    scaled = np.stack([s * diags[d] * s[(i + o) % n] for d, o in enumerate(offsets)])
    return DIAOperator.from_numpy(scaled, offsets, wrap_zero=True, dtype=torch.float32,
                                  device=dev)


def phase_precond(torch, dev) -> dict:
    """Jacobi-preconditioned PSBCGrQ and PBCG on the badly scaled 128^3
    Laplacian with k = 32 at tol 1e-5, beside unpreconditioned SBCGrQ capped
    at ``PRECOND_CAP`` iterations. PSBCGrQ monitors the M-norm, PBCG the
    2-norm; the true 2-norm relres is printed in f64. Both preconditioned
    solves must converge in under 0.7x the capped solve's iterations.
    Returns the launch counts of the two preconditioned solves."""
    from blockcg_tpu_torch import (
        jacobi_preconditioner,
        solve_pbcg,
        solve_psbcgrq,
        solve_sbcgrq,
    )
    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.problems.presets import _rhs

    op, build_s = _timed(torch, lambda: _scaled_laplacian(torch, dev))
    d = op.diags[op.offsets.index(0)]
    B = _rhs(op.n, K, torch.float32, device=dev)
    M = jacobi_preconditioner(op)
    print(f"[precond] D A D, A = 128^3 Laplacian, n={op.n} k={K}: built in {build_s:.1f} s, "
          f"diagonal from {float(d.min()):.3e} to {float(d.max()):.3e}")
    (_, iu), su = _timed(torch, lambda: solve_sbcgrq(op, B, tol=1e-5, max_iter=PRECOND_CAP))
    _native.reset_launches()
    runs = [(name, *_timed(torch, lambda fn=fn: fn(op, B, M, tol=1e-5, max_iter=2000)))
            for name, fn in (("solve_psbcgrq", solve_psbcgrq), ("solve_pbcg", solve_pbcg))]
    counts = dict(_native.launches)
    print(f"[precond] solve_sbcgrq (no preconditioner, capped at {PRECOND_CAP}): "
          f"{iu.iterations} iterations, {su:.3f} s, converged {bool(iu.converged.all())}, "
          f"monitor relres {float(iu.relres.max()):.3e}")
    for name, (X, info), secs in runs:
        rel = true_relres(torch, op, X, B)
        monitor = "M-norm" if name == "solve_psbcgrq" else "2-norm"
        print(f"[precond] {name} + jacobi_preconditioner: {info.iterations} iterations, "
              f"{secs:.3f} s, {monitor} monitor {float(info.relres.max()):.3e}, "
              f"true 2-norm relres {rel:.3e}")
        if not (bool(info.converged.all()) and info.iterations < 0.7 * iu.iterations):
            raise AssertionError(f"{name} with Jacobi: {info}, against {iu.iterations} "
                                 "unpreconditioned iterations")
    return counts


def phase_cheb(torch, dev) -> dict:
    """``solve_sbcgrq_cheb`` beside plain SBCGrQ on config 3 (64^3, k = 32)
    at degree 6 and on the 128^3 Laplacian with k = 32 at degree 4, tol 1e-6:
    iterations, matvecs, seconds and the f64 true relres, held at 1e-5 (the
    solver's own f32 check and the iteration counts are printed). Returns the
    launch counts of the Chebyshev solves."""
    from blockcg_tpu_torch import solve_sbcgrq, solve_sbcgrq_cheb
    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.problems import laplacian_dia
    from blockcg_tpu_torch.problems.presets import _rhs

    counts: dict = {}
    for edge, degree in CHEB_RUNS:
        op = laplacian_dia((edge,) * 3, device=dev)
        B = _rhs(op.n, K, torch.float32, device=dev)
        (_, ip), sp = _timed(torch, lambda: solve_sbcgrq(op, B, tol=1e-6, qr_passes=1))
        _native.reset_launches()
        (X, info), secs = _timed(torch, lambda: solve_sbcgrq_cheb(op, B, degree=degree,
                                                                  tol=1e-6))
        for w, c in _native.launches.items():
            counts[w] = counts.get(w, 0) + c
        rel = true_relres(torch, op, X, B)
        print(f"[cheb] {edge}^3 n={op.n} k={K} degree {degree}: solve_sbcgrq_cheb "
              f"{info.iterations} iterations, {info.matvecs} matvecs, {secs:.3f} s (spectrum "
              f"estimate included), own check {bool(info.converged.all())} at relres "
              f"{float(info.relres.max()):.3e}, f64 true relres {rel:.3e}; plain SBCGrQ "
              f"{ip.iterations} iterations, {sp:.3f} s")
        if not rel <= 1e-5:
            raise AssertionError(f"solve_sbcgrq_cheb at {edge}^3: true relres {rel:.3e}")
        del op, B, X
        torch.cuda.empty_cache()
    if counts.get("cheb_step", 0) == 0:
        raise AssertionError("the Chebyshev solves never launched cheb_step")
    return counts


def eo_true_relres(torch, eo, X, B, sigma: float = 0.0) -> float:
    """max_j ||B e_j - (A + sigma I) X e_j|| / ||B e_j|| for the full
    operator A = [[c I, -H_eo], [-H_oe, c I]] of an even-odd context, in f64
    on the card (complex fields in their realified form, whose norms are the
    complex ones)."""
    from blockcg_tpu_torch.problems import eo_split

    if B.is_complex():
        B, X = eo.complex_to_real(B), eo.complex_to_real(X)
    B64, X64 = B.double(), X.double()
    (be, bo), (xe, xo) = eo_split(eo, B64), eo_split(eo, X64)
    f = eo.c + sigma

    def hop(h, F):
        return h.astype_op(torch.float64).matmat_t(F.T.contiguous()).T
    re = be - (f * xe - hop(eo.hop_eo, xo))
    ro = bo - (f * xo - hop(eo.hop_oe, xe))
    r2 = (re * re).sum(0) + (ro * ro).sum(0)
    return float((torch.sqrt(r2) / torch.linalg.vector_norm(B64, dim=0)).max())


def phase_eo(torch, dev) -> dict:
    """The even-odd Schur path on 32^4: ``dirac_eo(32)`` with config 4's 12
    RHS through ``solve_dirac_eo`` twice (bitwise identical, X within
    ``EO_X_RTOL`` of config 4's full solve, true relres on the full operator
    <= 1e-5, here and through config 4's own operator); ``solver=solve_cg``
    on column 0 (the (k, bs, ns) kernels, true relres <= ``CG1_TRUE_RELRES``;
    its launch counts are returned); ``solve_dirac_eo_shifted`` with
    ``SHIFTS`` on the first ``EO_SHIFTED_K`` columns;
    ``dirac_gauged_matrix_eo(32)`` with 12 RHS and ``dirac_gauged_eo(32,
    complex64)`` with 6 complex RHS, each <= 1e-5. Builds are timed."""
    from blockcg_tpu_torch import solve_cg, solve_sbcgrq
    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.problems import (
        config4_dirac_32,
        dirac_eo,
        dirac_gauged_eo,
        dirac_gauged_matrix_eo,
        solve_dirac_eo,
        solve_dirac_eo_shifted,
    )

    op4, B, _ = config4_dirac_32(L=DIRAC_L, device=dev)
    (X4, i4), s4 = _timed(torch, lambda: solve_sbcgrq(op4, B, tol=1e-6, qr_passes=1))
    eo, build_s = _timed(torch, lambda: dirac_eo(DIRAC_L, device=dev))
    runs = [_timed(torch, lambda: solve_dirac_eo(eo, B, tol=1e-6)) for _ in range(2)]
    ((X1, info), s1), ((X2, info2), s2) = runs
    rel, rel4 = eo_true_relres(torch, eo, X1, B), true_relres(torch, op4, X1, B)
    dx = relfro(X1, X4)
    if not (bool(info.converged.all()) and max(rel, rel4) <= 1e-5 and dx <= EO_X_RTOL):
        raise AssertionError(f"dirac_eo(32) SBCGrQ: true relres {rel:.3e} / {rel4:.3e}, "
                             f"|X - X_config4| / |X_config4| {dx:.3e}: {info}")
    if not torch.equal(X1, X2):
        raise AssertionError("dirac_eo(32): the repeat solve is not bitwise identical")
    print(f"[eo] dirac_eo({DIRAC_L}) built in {build_s:.1f} s (half lattice ns={eo.ns // 2}, "
          f"{len(eo.hop_oe.main_offsets)} main diagonals, slabs {eo.hop_oe.slabs}); "
          f"solve_dirac_eo k={B.shape[1]} tol=1e-6: {info.iterations} iterations, {s1:.3f} s "
          f"(repeat {s2:.3f} s, {info2.iterations} iterations, bitwise identical), true relres "
          f"{rel:.3e} (by config 4's operator {rel4:.3e}); config 4's full solve "
          f"{i4.iterations} iterations, {s4:.3f} s, |X - X_config4| / |X_config4| {dx:.3e}")
    del X1, X2, X4, runs
    _native.reset_launches()
    (x, icg), scg = _timed(torch, lambda: solve_dirac_eo(eo, B[:, :1], solver=solve_cg,
                                                         tol=1e-6, max_iter=5000))
    cg_counts = dict(_native.launches)
    # Row 14 runs cm_spmm with the view's row map (bcg_cbs_merged_spmm): a
    # launch of the view's apply on cbs_spmm (bcg_cbs_spmm, row 15's alone
    # now) is the old route.
    cm, old = _native.functions["bcg_cbs_merged_spmm"], _native.functions["bcg_cbs_spmm"]
    hop = eo.hop_oe
    plan = hop.main_plans.get(hop.main_offsets, hop.masks_main.shape[0], 1, hop.ns, dev,
                              view=True)
    print(f"[plan] const_block_stencil_spmm_t dirac_eo({DIRAC_L}) hop_oe (1, {hop.bs}, "
          f"{hop.ns}): cm_spmm {plan.describe()}")
    print(f"[eo] the CG's (k, bs, ns) applies: {cg_counts.get('const_block_stencil_spmm_t', 0)} "
          f"launches of const_block_stencil_spmm_t, {cm} on cm_spmm (bcg_cbs_merged_spmm), "
          f"{old} on cbs_spmm")
    if not (cm == cg_counts.get("const_block_stencil_spmm_t", 0) > 0
            and old == cg_counts.get("const_block_stencil_spmm_gram_t", 0)):
        raise AssertionError(f"even-odd CG: row 14 launched {cm} times on cm_spmm and {old} "
                             "on cbs_spmm")
    rel = eo_true_relres(torch, eo, x, B[:, :1])
    print(f"[eo] solve_dirac_eo(solver=solve_cg) on column 0: {icg.iterations} iterations, "
          f"{scg:.3f} s, monitor relres {float(icg.relres.max()):.3e}, true relres {rel:.3e}, "
          f"launches {cg_counts}")
    if not (bool(icg.converged.all()) and rel <= CG1_TRUE_RELRES):
        raise AssertionError(f"even-odd CG: true relres {rel:.3e}: {icg}")
    Bs = B[:, :EO_SHIFTED_K]
    (Xs, ish), ssh = _timed(torch, lambda: solve_dirac_eo_shifted(eo, Bs, SHIFTS, tol=1e-6))
    rels = [eo_true_relres(torch, eo, Xs[j], Bs, sg) for j, sg in enumerate(SHIFTS)]
    print(f"[eo] solve_dirac_eo_shifted k={EO_SHIFTED_K} shifts {SHIFTS}: {ish.iterations} "
          f"iterations, {ssh:.3f} s, true relres {['%.3e' % r for r in rels]}")
    if not (bool(ish.converged.all()) and max(rels) <= 1e-5):
        raise AssertionError(f"even-odd multi-shift: true relres {rels}: {ish}")
    del eo, Xs, op4
    torch.cuda.empty_cache()

    rng = np.random.default_rng(ML_SEED)
    for label, build, k, cplx in (
            (f"dirac_gauged_matrix_eo({DIRAC_L})",
             lambda: dirac_gauged_matrix_eo(DIRAC_L, device=dev), DIRAC_K, False),
            (f"dirac_gauged_eo({DIRAC_L}, complex64)",
             lambda: dirac_gauged_eo(DIRAC_L, dtype=torch.complex64, device=dev),
             EO_COMPLEX_K, True)):
        geo, build_s = _timed(torch, build)
        nfull = geo.n // 2 if cplx else geo.n
        Bn = rng.standard_normal((nfull, k))
        if cplx:
            Bn = Bn + 1j * rng.standard_normal((nfull, k))
        Bg = torch.as_tensor(Bn, dtype=torch.complex64 if cplx else torch.float32, device=dev)
        (X, gi), secs = _timed(torch, lambda: solve_dirac_eo(geo, Bg, tol=1e-6))
        rel = eo_true_relres(torch, geo, X, Bg)
        print(f"[eo] {label} built in {build_s:.1f} s ({len(geo.hop_oe.offsets)} diagonals, "
              f"bs={geo.bs}), k={k}: {gi.iterations} iterations, {secs:.3f} s, true relres "
              f"{rel:.3e}")
        if not (X.dtype == Bg.dtype and bool(gi.converged.all()) and rel <= 1e-5):
            raise AssertionError(f"{label}: {X.dtype}, true relres {rel:.3e}: {gi}")
        del geo, X, Bg
        torch.cuda.empty_cache()
    return cg_counts


def phase_wide_kernels(torch, dev, records) -> None:
    """Every kernel the width repair touches, at m = 96 rows (above one
    launch's 64) against its plain version: the fused updates and the Gram
    on config 4's merged width (ns = 32^4, ``I_4 ⊗ C``), fresh and donated;
    ``mm2_update_gram``, ``px_update``, ``mm_update_gram``, ``xr_update_gram``
    and ``mm_update`` at 800 rows, where shared memory leaves room for narrow
    row chunks only (the Gram of ``xr_update_gram`` laid out by those chunks,
    those of ``mm2_update_gram`` and ``mm_update_gram`` taken by ``gram`` on
    64-row blocks); the DIA stencil on config 3's 64^3
    Laplacian; the const-hop kernels on
    config 4's operator with 24 RHS (merged, the (24, 4, ns) view, both slab
    adds); the block stencil on random per-site blocks (16^4 sites, bs = 4,
    k = 24). These checks fold into the records' max_abs_err only."""
    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.ops import block_stencil as bsk
    from blockcg_tpu_torch.ops import const_block_stencil as cbs
    from blockcg_tpu_torch.ops import fused, stencil
    from blockcg_tpu_torch.problems import dirac_cbdia, laplacian_dia

    gen = torch.Generator(device=dev).manual_seed(7)
    m, bs = WIDE_M, 4
    k = m // bs
    op = dirac_cbdia(DIRAC_L, device=dev)
    ns = op.ns

    def is_gram(w):
        return w.dim() == 2 and w.shape[0] == w.shape[1] == m or w.shape == (k, k)

    def coeff():
        C = torch.randn((k, k), generator=gen, device=dev) / k ** 0.5
        return torch.kron(torch.eye(bs, device=dev), C)
    M1, M2, M3 = coeff(), coeff(), coeff()
    F = [torch.randn((m, ns), generator=gen, device=dev) for _ in range(4)]
    fb, gb, gf, sf = nbytes(F[0]), m * m * 4, 2 * m * m * ns, syrk_flops(m, ns)
    what = f"ns={ns} m={m} I_{bs}⊗C"

    def both_ways(name, fn, plain, nf, work, library=None):
        """``fn(*fields, donate)`` fresh, then donated (on fresh copies)."""
        def want():
            return _tuple(plain(*F[:nf]))
        _timed_check(torch, name, f"{what} fresh", lambda: _tuple(fn(*F[:nf], False)), want,
                     is_gram, records, work=work, library=library)
        bufs = [f.clone() for f in F[:nf]]

        def in_place():
            return _tuple(fn(*bufs, True))

        def kern():
            for b, f in zip(bufs, F):
                b.copy_(f)
            return in_place()
        _timed_check(torch, name, f"{what} in place", kern, want, is_gram, records,
                     timed=(in_place, want), work=work)

    _timed_check(torch, "gram", what, lambda: (None, fused.gram(F[0], F[1])),
                 lambda: (None, fused.gram_plain(F[0], F[1])), is_gram, records,
                 work=(2 * fb + gb, gf), library=lambda: F[0] @ F[1].T)
    _timed_check(torch, "gram", what + " U is V", lambda: (None, fused.gram(F[0], F[0])),
                 lambda: (None, fused.gram_plain(F[0], F[0])), is_gram, records,
                 work=(fb + gb, sf), library=lambda: F[0] @ F[0].T)
    Gs = fused.gram(F[0], F[0])
    if not torch.equal(Gs, Gs.T):
        raise AssertionError("gram: U is V at m = 96 is not exactly symmetric")
    print(f"[kernel] gram {what} U is V: one launch, exactly symmetric")
    mm = (nbytes(M1) + 2 * fb, 2 * ns * nnz(M1))
    both_ways("mm_update", lambda b, a, d: fused.mm_update(M1, b, a, donate="a" if d else None),
              lambda b, a: fused.mm_update_plain(M1, b, a), 2, (mm[0] + fb, mm[1]),
              library=lambda: torch.addmm(F[1], M1, F[0]))
    both_ways("mm_update_gram", lambda b, d: fused.mm_update_gram(M1, b, donate=d),
              lambda b: fused.mm_update_gram_plain(M1, b), 1, (mm[0] + gb, mm[1] + sf))
    both_ways("mm2_update_gram", lambda b1, b2, d: fused.mm2_update_gram(M1, b1, M2, b2, donate=d),
              lambda b1, b2: fused.mm2_update_gram_plain(M1, b1, M2, b2), 2,
              (nbytes(M1, M2) + 3 * fb + gb, 2 * ns * nnz(M1, M2) + sf))
    both_ways("px_update", lambda w, p, x, d: fused.px_update(M1, w, M2, p, M3, x, donate=d),
              lambda w, p, x: fused.px_update_plain(M1, w, M2, p, M3, x), 3,
              (nbytes(M1, M2, M3) + 5 * fb, 2 * ns * nnz(M1, M2, M3)))
    both_ways("xr_update_gram",
              lambda p, x, z, r, d: fused.xr_update_gram(M1, p, x, z, r, donate=d),
              lambda p, x, z, r: fused.xr_update_gram_plain(M1, p, x, z, r), 4,
              (nbytes(M1) + 6 * fb + gb, 4 * ns * nnz(M1) + sf))
    both_ways("qr_p_update", lambda q, p, d: fused.qr_p_update(M1, q, M2, p, donate=d),
              lambda q, p: fused.qr_p_update_plain(M1, q, M2, p), 2,
              (nbytes(M1, M2) + 4 * fb, 2 * ns * nnz(M1, M2)))
    plan = fused.qr_p_update_plan(m, dev)
    if len(plan.chunks) != 1 or not plan.in_place:
        raise AssertionError(f"qr_p_update at m = {m}: {plan}, not one launch in place")
    print(f"[plan] qr_p_update m={m}: {plan}")
    print(f"[plan] xr_update_gram m={m}: {fused.xr_update_gram_plan(m, dev)}")

    kw, nw = NARROW_CHUNK_K, NARROW_CHUNK_N
    Mw = [torch.randn((kw, kw), generator=gen, device=dev) / kw ** 0.5 for _ in range(3)]
    Fw = [torch.randn((kw, nw), generator=gen, device=dev) for _ in range(4)]
    wb, wg = nbytes(Fw[0]), (kw * kw * 4, syrk_flops(kw, nw))

    def what_w(chunks):
        return f"n={nw} k={kw} ({len(chunks)} launches of {chunks[0][1]} rows)"

    def is_gram_w(w):
        return w.shape == (kw, kw)
    _timed_check(torch, "mm2_update_gram", what_w(fused.mm2_update_gram_plan(kw, dev).chunks),
                 lambda: fused.mm2_update_gram(Mw[0], Fw[0], Mw[1], Fw[1]),
                 lambda: fused.mm2_update_gram_plain(Mw[0], Fw[0], Mw[1], Fw[1]), is_gram_w,
                 records, work=(nbytes(*Mw[:2]) + 3 * wb + wg[0], 4 * kw * kw * nw + wg[1]))
    _timed_check(torch, "px_update", what_w(fused.px_update_plan(kw, dev).chunks),
                 lambda: fused.px_update(Mw[0], Fw[0], Mw[1], Fw[1], Mw[2], Fw[2]),
                 lambda: fused.px_update_plain(Mw[0], Fw[0], Mw[1], Fw[1], Mw[2], Fw[2]),
                 is_gram_w, records, work=(nbytes(*Mw) + 5 * wb, 6 * kw * kw * nw))
    _timed_check(torch, "mm_update_gram", what_w(fused.mm_update_gram_plan(kw, dev).chunks),
                 lambda: fused.mm_update_gram(Mw[0], Fw[0], Fw[1]),
                 lambda: fused.mm_update_gram_plain(Mw[0], Fw[0], Fw[1]), is_gram_w, records,
                 work=(nbytes(Mw[0]) + 3 * wb + wg[0], 2 * kw * kw * nw + wg[1]))
    xr_plan = fused.xr_update_gram_plan(kw, dev)
    print(f"[plan] xr_update_gram k={kw}: {len(xr_plan.chunks)} launches of "
          f"{xr_plan.chunks[0][1]} rows, kc={xr_plan.kc}, {xr_plan.smem_bytes} shared bytes, "
          f"{xr_plan.blocks_per_sm} blocks an SM, grid {xr_plan.grid}")
    _timed_check(torch, "xr_update_gram", what_w(xr_plan.chunks),
                 lambda: fused.xr_update_gram(Mw[0], *Fw),
                 lambda: fused.xr_update_gram_plain(Mw[0], *Fw), is_gram_w, records,
                 work=(nbytes(Mw[0]) + 6 * wb + wg[0], 4 * kw * kw * nw + wg[1]))
    _timed_check(torch, "mm_update", what_w(fused.mm_update_plan(kw, None, dev)[0]),
                 lambda: (fused.mm_update(Mw[0], Fw[0], Fw[1]), None),
                 lambda: (fused.mm_update_plain(Mw[0], Fw[0], Fw[1]), None), is_gram_w,
                 records, work=(nbytes(Mw[0]) + 3 * wb, 2 * kw * kw * nw),
                 library=lambda: torch.addmm(Fw[1], Mw[0], Fw[0]))
    del Mw, Fw

    Xm, Ym = F[0], F[1]
    main = (op.hops_main, op.main_offsets, op.main_slots, op.masks_main)
    mwork = (nbytes(op.hops_main, op.masks_main) + 2 * fb, 2 * k * _cbs_nnz(op, True))
    _timed_check(torch, "const_block_stencil_spmm_m_t", f"config 4 ns={ns} m={m}",
                 lambda: (cbs.const_block_stencil_spmm_m_t(*main, Xm, op.main_plans), None),
                 lambda: cbs.const_block_stencil_plain(*main, Xm), is_gram, records, work=mwork)
    _timed_check(torch, "const_block_stencil_spmm_m_gram_t", f"config 4 ns={ns} m={m}",
                 lambda: cbs.const_block_stencil_spmm_m_gram_t(*main, Xm, op.main_plans),
                 lambda: cbs.const_block_stencil_plain(*main, Xm, True), is_gram, records,
                 work=(mwork[0] + gb, mwork[1] + gf))
    print(f"[plan] const_block_stencil_spmm_m_t and _m_gram_t config 4 m={m}: "
          f"{_cbs_plans(op, Xm)}")
    Xv = Xm.reshape(k, bs, ns)
    _timed_check(torch, "const_block_stencil_spmm_t", f"config 4 ({k}, {bs}, {ns})",
                 lambda: (cbs.const_block_stencil_spmm_t(*main, Xv), None),
                 lambda: cbs.const_block_stencil_v_plain(*main, Xv), is_gram, records,
                 work=mwork)
    _timed_check(torch, "const_block_stencil_spmm_gram_t", f"config 4 ({k}, {bs}, {ns})",
                 lambda: cbs.const_block_stencil_spmm_gram_t(*main, Xv),
                 lambda: cbs.const_block_stencil_v_plain(*main, Xv, True), is_gram, records,
                 work=(mwork[0] + 4 * k * k, mwork[1] + 2 * k * k * bs * ns))
    d, g, nblocks, mul, off, shift = op.slabs[0]
    cols = g * nblocks
    Gm = torch.randn((m, m), generator=gen, device=dev)
    Yk, Yp = Ym.clone(), Ym.clone()
    slab = (op.hops_all[d], g, nblocks, mul, off, shift, Xm)
    swork = (3 * 4 * m * cols, 2 * k * nnz(op.hops_all[d]) * cols)
    slab_lib, why = _slab_library(torch, op.hops_all[d], g, nblocks, mul, off, shift, Xm, Ym,
                                  cbs.slab_m_accumulate(*slab, Ym.clone()))
    _library_note(f"slab_m_accumulate config 4 m={m} (baddbmm_ on the slab's blocks)", why)
    print(f"[plan] slab_m_accumulate config 4 m={m}: {_slab_plans(torch, cbs, slab, Ym)}")
    for with_gram in (False, True):
        _native.reset_launches()
        cbs.slab_m_accumulate(*slab, Yk, Gm, with_gram=with_gram)
        if dict(_native.launches) != {"slab_m_accumulate": 1}:
            raise AssertionError(f"slab_m_accumulate at m={m}: {dict(_native.launches)} "
                                 "launches for one slab add")
        print(f"[plan] slab_m_accumulate config 4 m={m}" + " with Gram" * with_gram
              + f": one launch, {dict(_native.functions)}")
        _timed_check(torch, "slab_m_accumulate", f"config 4 m={m} slab" + " with Gram" * with_gram,
                     lambda: _tuple((Yk.copy_(Ym), cbs.slab_m_accumulate(
                         *slab, Yk, Gm, with_gram=with_gram))[1]),
                     lambda: _tuple((Yp.copy_(Ym), cbs.slab_plain(*slab, Yp, Gm, with_gram))[1]),
                     is_gram, records, work=(swork[0] + with_gram * 4 * m * (cols + 2 * m),
                                             swork[1] + with_gram * 2 * m * m * cols),
                     timed=(lambda: cbs.slab_m_accumulate(*slab, Yk, Gm, with_gram=with_gram),
                            lambda: cbs.slab_plain(*slab, Yp, Gm, with_gram)),
                     library=None if with_gram else slab_lib)
    Yvk, Yvp = Yk.reshape(k, bs, ns), Yp.reshape(k, bs, ns)
    vslab = (op.hops_all[d], g, nblocks, mul, off, shift, Xv)
    _timed_check(torch, "slab_block_accumulate", f"config 4 ({k}, {bs}, {ns}) slab",
                 lambda: (Yvk.copy_(Ym.reshape(k, bs, ns)), cbs.slab_block_accumulate(
                     *vslab, Yvk))[1:],
                 lambda: (Yvp.copy_(Ym.reshape(k, bs, ns)), cbs.slab_v_plain(*vslab, Yvp))[1:],
                 is_gram, records, work=swork,
                 timed=(lambda: cbs.slab_block_accumulate(*vslab, Yvk),
                        lambda: cbs.slab_v_plain(*vslab, Yvp)))
    del F, Xm, Ym, Yk, Yp, Xv, Yvk, Yvp, op, main, slab, vslab
    torch.cuda.empty_cache()

    lap = laplacian_dia(SHAPES[1], device=dev)
    X = torch.randn((m, lap.n), generator=gen, device=dev)
    swork = (nbytes(lap.diags) + 2 * nbytes(X), 2 * m * nnz(lap.diags))
    _timed_check(torch, "stencil_spmm_t", f"n={lap.n} k={m}",
                 lambda: (stencil.stencil_spmm_t(lap.diags, lap.offsets, X), None),
                 lambda: stencil.stencil_spmm_plain(lap.diags, lap.offsets, X), is_gram,
                 records, work=swork)
    _timed_check(torch, "stencil_spmm_gram_t", f"n={lap.n} k={m}",
                 lambda: stencil.stencil_spmm_gram_t(lap.diags, lap.offsets, X),
                 lambda: stencil.stencil_spmm_plain(lap.diags, lap.offsets, X, True), is_gram,
                 records, work=(swork[0] + gb, swork[1] + syrk_flops(m, lap.n)))
    del lap, X
    bns = 16 ** 4
    offsets = (0, 1, -1, 16, -16, 256, -256, 4096, -4096)
    blocks = torch.randn((len(offsets), bs, bs, bns), generator=gen, device=dev)
    Xb = torch.randn((m, bns), generator=gen, device=dev)
    bwork = (nbytes(blocks, Xb, Xb), 2 * k * nnz(blocks))
    what = f"random blocks ns={bns} bs={bs} k={k} m={m}"
    _timed_check(torch, "block_stencil_spmm_m_t", what,
                 lambda: (bsk.block_stencil_spmm_m_t(blocks, offsets, Xb), None),
                 lambda: bsk.block_stencil_plain(blocks, offsets, Xb), is_gram, records,
                 work=bwork)
    _timed_check(torch, "block_stencil_spmm_m_gram_t", what,
                 lambda: bsk.block_stencil_spmm_m_gram_t(blocks, offsets, Xb),
                 lambda: bsk.block_stencil_plain(blocks, offsets, Xb, True), is_gram, records,
                 work=(bwork[0] + gb, bwork[1] + syrk_flops(m, bns)))
    Xbv = Xb.reshape(k, bs, bns)
    _timed_check(torch, "block_stencil_spmm_t", f"random blocks ({k}, {bs}, {bns}) view",
                 lambda: (bsk.block_stencil_spmm_t(blocks, offsets, Xbv), None),
                 lambda: (bsk.block_stencil_v_plain(blocks, offsets, Xbv), None), is_gram,
                 records, work=bwork)
    del blocks, Xb, Xbv
    torch.cuda.empty_cache()


def _tuple(out):
    return out if isinstance(out, tuple) else (out, None)


def phase_qr_px(torch, dev, records) -> None:
    """``qr_px_update`` against its plain version at (32, 128^3) and config
    4's merged (48, 32^4) on ``I_4 ⊗ C``, fresh and in place (from fresh
    copies), and timed against the pair it replaces, ``qr_p_update`` then
    ``mm_update``. The record takes the first shape's times."""
    from blockcg_tpu_torch.ops import fused

    gen = torch.Generator(device=dev).manual_seed(8)
    for k, n in QR_PX_SHAPES:
        bs = 1 if n == 128 ** 3 else 4

        def coeff():
            C = torch.randn((k // bs, k // bs), generator=gen, device=dev) / (k // bs) ** 0.5
            return torch.kron(torch.eye(bs, device=dev), C)
        M2, rho, C = coeff(), coeff(), coeff()
        Q1, P, X = (torch.randn((k, n), generator=gen, device=dev) for _ in range(3))
        fb = nbytes(Q1)
        work = (nbytes(M2, rho, C) + 6 * fb, 2 * n * nnz(M2, rho, C))
        what = f"({k}, {n})" + (f" I_{bs}⊗C" if bs > 1 else "")

        def want():
            return fused.qr_px_update_plain(M2, Q1, rho, P, C, X)
        _timed_check(torch, "qr_px_update", f"{what} fresh",
                     lambda: fused.qr_px_update(M2, Q1, rho, P, C, X), want, lambda w: False,
                     records, work=work)
        bufs = [Q1.clone(), P.clone(), X.clone()]

        def in_place():
            return fused.qr_px_update(M2, bufs[0], rho, bufs[1], C, bufs[2], donate=True)

        def kern():
            for b, f in zip(bufs, (Q1, P, X)):
                b.copy_(f)
            return in_place()
        _timed_check(torch, "qr_px_update", f"{what} in place", kern, want, lambda w: False,
                     records, timed=(in_place, want), work=work)

        def pair():
            Q, Pn = fused.qr_p_update(M2, Q1, rho, P)
            return Q, Pn, fused.mm_update(C, P, X)
        fused_ms, pair_ms = (median_ms(torch, fn) for fn in (
            lambda: fused.qr_px_update(M2, Q1, rho, P, C, X), pair))
        print(f"[kernel] qr_px_update {what}: {fused_ms:.4f} ms against qr_p_update + "
              f"mm_update {pair_ms:.4f} ms (6 field passes against 7)")
        del Q1, P, X, bufs
        torch.cuda.empty_cache()


def _sparse_work(op, k):
    """(bytes, FLOPs) of one tiled apply: every tile read once, X read once
    and Y written once, the row pointers and indices; 2 k T^2 FLOPs a
    tile."""
    return (nbytes(op.tiles, op.rt, op.ct, op.first, op.row_ptr) + 2 * 4 * k * op.n,
            2 * op.ntiles * k * 128 * 128)


def _bsr_library(torch, op, Xt):
    """One PyTorch call computing the same product: A (a torch BSR tensor of
    the same tiles, blocksize 128, columns sorted in each row) times the
    dense X^T. Returns (callable, None) or (None, why)."""
    try:
        order = torch.argsort(op.rt.long() * (op.n // 128) + op.ct.long())
        A = torch.sparse_bsr_tensor(op.row_ptr.long(), op.ct[order].long(),
                                    op.tiles[order].float(), size=(op.n, op.n))
        X = Xt.T.contiguous()

        def call():
            return A @ X
        Y = call()
        torch.cuda.synchronize()
        if not torch.allclose(Y.T, op.matmat_t(Xt), rtol=1e-4, atol=1e-4 * float(Y.abs().max())):
            return None, "torch's BSR product disagrees with the kernel"
        return call, None
    except (RuntimeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"


def phase_sparse_kernel(torch, dev, records, op) -> None:
    """``tiled_spmm_t`` against its plain version at the ``[sparse]`` shape
    (the RCM tiles of the RGG graph, k = 32) with f32 and with bf16 tiles,
    and at k = 96 (one launch of 12 warps): kernel, plain, bound and library ms, and
    Gnnz/s on the logical nonzeros, each with the ``tiled_plan`` it ran. The
    record takes the f32, k = 32 times."""
    from blockcg_tpu_torch.operators import TiledOperator
    from blockcg_tpu_torch.ops import spmm_tiled

    gen = torch.Generator(device=dev).manual_seed(9)
    bf = TiledOperator(op.tiles.to(torch.bfloat16), op.rt, op.ct, op.first, op.n, op.perm,
                       op.n0, op.nnz_logical)
    for o, k, label in ((op, SPARSE_K, "f32 tiles"), (bf, SPARSE_K, "bf16 tiles"),
                        (op, SPARSE_WIDE_K, "f32 tiles")):
        Xt = torch.randn((k, o.n), generator=gen, device=dev)
        library, why = _bsr_library(torch, o, Xt)
        args = (o.tiles, o.rt, o.ct, o.first)
        ms = _timed_check(torch, "tiled_spmm_t", f"n={o.n} k={k} {label} {o.ntiles} tiles",
                          lambda: (spmm_tiled.tiled_spmm_t(*args, Xt, o.row_ptr, o.tiled_plan),
                                   None),
                          lambda: (spmm_tiled.tiled_spmm_plain(o.tiles, o.rt, o.ct, Xt), None),
                          lambda w: False, records, work=_sparse_work(o, k), library=library)
        x_per_tile = nbytes(o.tiles) + 4 * k * 128 * o.ntiles + 4 * k * o.n
        print(f"[kernel] tiled_spmm_t k={k} {label} plan: {o.tiled_plan(k).describe()}")
        print(f"[kernel] tiled_spmm_t k={k} {label}: {o.nnz / ms / 1e6:.2f} Gnnz/s on "
              f"{o.nnz} logical nonzeros (fill {o.fill:.4%}); bound with X read once a tile: "
              f"{bound_ms(x_per_tile, _sparse_work(o, k)[1])[0]:.4f} ms; library: "
              + ("torch BSR @ dense" if why is None else f"none ({why})"))
        del Xt
    del bf
    torch.cuda.empty_cache()


def phase_sparse(torch, dev, records) -> dict:
    """General sparsity at full size: ``rgg_laplacian(524288, degree=40)``
    through ``from_scipy_auto`` (which must pick the RCM tile format, with the
    native tilizer), 32 RHS from ``default_rng(0)`` in the original order
    through ``to_solver_order`` -> ``solve_sbcgrq`` (tol 1e-6, twice, bitwise
    identical, true f64 relres against scipy's matrix <= 1e-5) ->
    ``from_solver_order``; then ``solve_refined`` to 1e-10 with the f64 CSR
    outer operator in internal order, with f32 and with bf16 tiles. Then
    the kernel checks at this shape. Returns the solves' launch counts."""
    from blockcg_tpu_torch import native, solve_refined, solve_sbcgrq
    from blockcg_tpu_torch.operators import CSROperator, TiledOperator, from_scipy_auto
    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.problems import rgg_laplacian

    a, gen_s = _timed(torch, lambda: rgg_laplacian(SPARSE_N, degree=SPARSE_DEGREE, seed=0))
    op, auto_s = _timed(torch, lambda: from_scipy_auto(a, torch.float32, verbose=True,
                                                       device=dev))
    if not (isinstance(op, TiledOperator) and op.perm is not None and native.have_native()):
        raise AssertionError(f"[sparse] from_scipy_auto picked {type(op).__name__} (perm "
                             f"{op.perm is not None if hasattr(op, 'perm') else None}, native "
                             f"tilizer {native.have_native()}): expected TiledOperator + RCM")
    print(f"[sparse] rgg_laplacian({SPARSE_N}, degree={SPARSE_DEGREE}) nnz={a.nnz} built in "
          f"{gen_s:.1f} s; from_scipy_auto -> TiledOperator + RCM in {auto_s:.1f} s (native "
          f"tilizer {native.library_path().name}): fill {op.fill:.4%}, {op.ntiles} tiles, "
          f"{nbytes(op.tiles) / 1e9:.3f} GB of f32 tiles")
    rng = np.random.default_rng(0)
    Bn = rng.standard_normal((a.shape[0], SPARSE_K))
    B = torch.as_tensor(Bn, dtype=torch.float32, device=dev)
    Bp = op.to_solver_order(B)

    def relres(X):
        Xn = X.double().cpu().numpy()
        return float((np.linalg.norm(Bn - a @ Xn, axis=0) / np.linalg.norm(Bn, axis=0)).max())
    _native.reset_launches()
    runs = [_timed(torch, lambda: solve_sbcgrq(op, Bp, tol=1e-6, qr_passes=1)) for _ in range(2)]
    ((X1, info), s1), ((X2, info2), s2) = runs
    rel = relres(op.from_solver_order(X1))
    if not (bool(info.converged.all()) and rel <= 1e-5):
        raise AssertionError(f"[sparse] SBCGrQ true relres {rel:.3e}: {info}")
    if not torch.equal(X1, X2):
        raise AssertionError("[sparse] the repeat SBCGrQ solve is not bitwise identical")
    print(f"[sparse] the apply's tiled_plan at k={SPARSE_K}: "
          f"{op.tiled_plan(SPARSE_K).describe()}")
    print(f"[sparse] solve_sbcgrq k={SPARSE_K} tol=1e-6 qr_passes=1: {info.iterations} "
          f"iterations, {s1:.3f} s (repeat {s2:.3f} s, {info2.iterations} iterations, bitwise "
          f"identical), true f64 relres {rel:.3e}")
    del X1, X2, runs
    op64 = CSROperator.from_scipy(op.reordered_scipy(a), torch.float64, device=dev)
    bf = TiledOperator(op.tiles.to(torch.bfloat16), op.rt, op.ct, op.first, op.n, op.perm,
                       op.n0, op.nnz_logical)
    # The refinement's residual is f64: it takes B unrounded.
    Bp64 = op.to_solver_order(torch.as_tensor(Bn, dtype=torch.float64, device=dev))
    first = None
    for label, o in (("f32 tiles", op), ("f32 tiles, repeat", op), ("bf16 tiles", bf)):
        (X, rinfo), secs = _timed(torch, lambda: solve_refined(o, Bp64, tol=1e-10,
                                                               inner_tol=3e-6, op64=op64))
        rel = relres(o.from_solver_order(X))
        if not (bool(rinfo.converged.all()) and rel <= 1e-10):
            raise AssertionError(f"[sparse] solve_refined with {label}: true relres {rel:.3e}: "
                                 f"{rinfo}")
        same = ""
        if first is None:
            first = X
        elif o is op:
            if not torch.equal(X, first):
                raise AssertionError("[sparse] the repeat solve_refined is not bitwise identical")
            same = ", bitwise identical"
        else:
            same = f", bitwise the f32 tiles' X: {torch.equal(X, first)}"
        print(f"[sparse] solve_refined tol=1e-10 {label} (op64: f64 CSR in internal order): "
              f"{rinfo.iterations} cycles, {rinfo.matvecs} matvecs, {secs:.3f} s, true f64 "
              f"relres {rel:.3e}{same}")
        del X
    del first
    counts = dict(_native.launches)
    del bf, op64
    torch.cuda.empty_cache()
    phase_sparse_kernel(torch, dev, records, op)
    return counts


def phase_scattered(torch, dev) -> None:
    """The reference's ``bench_scattered.py`` problem set at its own sizes
    (n = 32,768; 16,384 for the two no-locality graphs), k = 32: one line
    per (problem, format) with the tile fill and Gnnz/s of ``matmat_t`` on
    the card: the H100 rates beside the auto-selector's v5e constants."""
    from blockcg_tpu_torch.operators import CSROperator, ELLOperator, TiledOperator
    from blockcg_tpu_torch.problems import (
        delaunay_laplacian,
        random_regular_spd,
        rgg_laplacian,
        uniform_random_spd,
    )

    n = SCATTERED_N
    problems = [("delaunay", lambda: delaunay_laplacian(n, seed=0))]
    problems += [(f"rgg_deg{d}", lambda d=d: rgg_laplacian(n, degree=d, seed=0))
                 for d in (10, 20, 40)]
    problems += [("uniform_deg8", lambda: uniform_random_spd(min(n, 16384), degree=8.0, seed=0)),
                 ("regular_deg8", lambda: random_regular_spd(min(n, 16384), degree=8, seed=0))]
    formats = (
        ("csr", lambda a: CSROperator.from_scipy(a, torch.float32, device=dev)),
        ("ell", lambda a: ELLOperator.from_scipy(a, torch.float32, device=dev)),
        ("rcm_f32", lambda a: TiledOperator.from_scipy(a, torch.float32, reorder="rcm",
                                                       max_pad_bytes=4 << 30, device=dev)),
        ("rcm_bf16", lambda a: TiledOperator.from_scipy(
            a, torch.float32, reorder="rcm", tile_dtype=torch.bfloat16,
            max_pad_bytes=4 << 30, device=dev)),
    )
    gen = torch.Generator(device=dev).manual_seed(10)
    for pname, build in problems:
        a = build()
        for fname, make in formats:
            o = make(a)
            Xt = torch.randn((K, o.n), generator=gen, device=dev)
            ms = median_ms(torch, lambda: o.matmat_t(Xt))
            fill = f", fill {o.fill:.4%}, {o.ntiles} tiles" if hasattr(o, "fill") else ""
            print(f"[scattered] {pname} n={a.shape[0]} nnz={a.nnz} {fname}: {ms:.4f} ms, "
                  f"{a.nnz / ms / 1e6:.3f} Gnnz/s{fill}")
            del o, Xt
    torch.cuda.empty_cache()


def phase_bell(torch, dev) -> None:
    """``dirac_bell(32)``, config 4's matrix as site-major BSR (plain gathers),
    with config 4's B through SBCGrQ at tol 1e-6: iterations beside config
    4's and X within ``BELL_X_RTOL`` of the const-hop solve's X (in the same
    row order)."""
    from blockcg_tpu_torch import solve_sbcgrq
    from blockcg_tpu_torch.problems import config4_dirac_32, dirac_bell

    cop, B, _ = config4_dirac_32(L=DIRAC_L, device=dev)
    (Xc, ic), sc = _timed(torch, lambda: solve_sbcgrq(cop, B, tol=1e-6, qr_passes=1))
    ns = cop.ns
    del cop
    torch.cuda.empty_cache()

    def site_major(F):  # row a * ns + s -> row s * 4 + a
        return F.reshape(4, ns, -1).transpose(0, 1).reshape(4 * ns, -1)
    bop, build_s = _timed(torch, lambda: dirac_bell(DIRAC_L, device=dev))
    (Xb, ib), sb = _timed(torch, lambda: solve_sbcgrq(bop, site_major(B), tol=1e-6,
                                                      qr_passes=1))
    dx = relfro(Xb, site_major(Xc))
    rel = true_relres(torch, bop, Xb, site_major(B))
    if not (bool(ib.converged.all()) and rel <= 1e-5 and dx <= BELL_X_RTOL):
        raise AssertionError(f"[bell] dirac_bell({DIRAC_L}): {ib.iterations} iterations, true "
                             f"relres {rel:.3e}, |Xb - Xc| / |Xc| {dx:.3e}")
    print(f"[bell] dirac_bell({DIRAC_L}) (BSR, built in {build_s:.1f} s, nnz {bop.nnz}): "
          f"{ib.iterations} iterations (config 4: {ic.iterations}, reference "
          f"{DIRAC_REF_ITERS}), {sb:.3f} s against the const-hop {sc:.3f} s; "
          f"|Xb - Xc| / |Xc| {dx:.3e}, true relres {rel:.3e}")


def _slab_launches(_native, op) -> str:
    """Checks that the solves counted in ``_native`` launched
    ``slab_m_accumulate`` once a slab add: each merged apply (one main
    launch, with or without the Gram) adds each of ``op.slabs``."""
    applies = sum(_native.launches[w] for w in ("const_block_stencil_spmm_m_t",
                                                  "const_block_stencil_spmm_m_gram_t"))
    slabs = _native.launches["slab_m_accumulate"]
    if slabs != len(op.slabs) * applies or _native.functions["bcg_slab_stream"] != slabs:
        raise AssertionError(f"{slabs} slab_m_accumulate launches for {applies} applies of "
                             f"{len(op.slabs)} slabs: {dict(_native.functions)}")
    return (f"slab adds: {slabs} slab_m_accumulate launches for {applies} merged applies of "
            f"{len(op.slabs)} slabs (one launch a slab add, bcg_slab_stream)")


def phase_wide_solves(torch, dev) -> dict:
    """Solves on fields of m = 96 rows: config 4's SBCGrQ with 24 RHS (seed
    42), and ``solve_dirac_eo_shifted`` on ``dirac_eo(32)`` with config 4's
    12 RHS (2k = 24 columns) and ``SHIFTS``, each true relres <= 1e-5.
    Returns their launch counts."""
    from blockcg_tpu_torch import solve_sbcgrq
    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.problems import config4_dirac_32, dirac_eo, solve_dirac_eo_shifted
    from blockcg_tpu_torch.problems.presets import _rhs

    op, B12, _ = config4_dirac_32(L=DIRAC_L, device=dev)
    B = _rhs(op.n, WIDE_CONFIG4_K, torch.float32, device=dev)
    _native.reset_launches()
    (X, info), secs = _timed(torch, lambda: solve_sbcgrq(op, B, tol=1e-6, qr_passes=1))
    rel = true_relres(torch, op, X, B)
    if not (bool(info.converged.all()) and rel <= 1e-5):
        raise AssertionError(f"[wide] config 4 with {WIDE_CONFIG4_K} RHS: true relres "
                             f"{rel:.3e}: {info}")
    print(f"[wide] config 4 SBCGrQ k={WIDE_CONFIG4_K} (m = {4 * WIDE_CONFIG4_K}) tol=1e-6: "
          f"{info.iterations} iterations, {secs:.3f} s, true relres {rel:.3e}")
    print(f"[wide] {_slab_launches(_native, op)}")
    del op, X
    torch.cuda.empty_cache()
    eo = dirac_eo(DIRAC_L, device=dev)
    (Xs, ish), ssh = _timed(torch, lambda: solve_dirac_eo_shifted(eo, B12, SHIFTS, tol=1e-6))
    rels = [eo_true_relres(torch, eo, Xs[j], B12, sg) for j, sg in enumerate(SHIFTS)]
    if not (bool(ish.converged.all()) and max(rels) <= 1e-5):
        raise AssertionError(f"[wide] even-odd multi-shift on 12 RHS: true relres {rels}: {ish}")
    print(f"[wide] solve_dirac_eo_shifted k={DIRAC_K} (2k = {2 * DIRAC_K} columns, m = "
          f"{8 * DIRAC_K}) shifts {SHIFTS}: {ish.iterations} iterations, {ssh:.3f} s, true "
          f"relres {['%.3e' % r for r in rels]}")
    del eo, Xs
    torch.cuda.empty_cache()
    return dict(_native.launches)


# ---- config 5 at full size: the bf16 capacity route and the f32 route.


def bf16_ulps(torch, got, want, chunk: int = 1 << 25) -> float:
    """Largest |got - want| of two fields of one shape, in bf16 ulps of the
    larger of the two, at least of 2^-8 of the largest |want|, ``chunk``
    elements at a time on the card."""
    got, want = got.reshape(-1), want.reshape(-1)
    worst, floor = 0.0, float(want.abs().max()) * 2.0 ** -8
    for i in range(0, want.numel(), chunk):
        g, w = got[i:i + chunk].float(), want[i:i + chunk].float()
        m = torch.clamp_min(torch.maximum(g.abs(), w.abs()), floor)
        ulp = torch.exp2(torch.floor(torch.log2(torch.where(m > 0, m, torch.ones_like(m)))) - 7)
        worst = max(worst, float(((g - w).abs() / ulp).max()))
    return worst


def bf16_compare(torch, name, what, got, want, gram_rtol) -> tuple[float, float]:
    """Hold a bf16 variant's outputs against its plain version's: a stored
    bf16 field within ``BF16_ULPS``, an f32 Gram within ``gram_rtol``
    (relative Frobenius). Returns (the largest error, the largest absolute
    difference)."""
    torch.cuda.synchronize()
    errs, abs_err = [], 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if w.dtype == torch.float32:
            err = relfro(g, w)
            _check(f"{name} ({what})", "Gram", err, gram_rtol)
        else:
            err = bf16_ulps(torch, g, w)
            _check(f"{name} ({what})", f"output {i} (bf16 ulps)", err, BF16_ULPS)
        errs.append(err)
        abs_err = max(abs_err, float((g.float() - w.float()).abs().max()))
    return max(errs), abs_err


def contract_distance(torch, tag, name, what, G, contract, other, margin: float) -> None:
    """A fused Gram G against the f64 Gram of the operand pair its contract
    names and of the other candidate (None: there is none): e_c and e_o are
    relative Frobenius distances; the check needs e_c <= GRAM_RTOL and
    margin * e_c < e_o. Prints one line after the phase's ``tag``."""
    e_c, e_o = (float("inf") if p is None else
                relfro(G.double(), p[0].double() @ p[1].double().T) for p in (contract, other))
    print(f"{tag} gram contract {name} {what}: {e_c:.3e} from its contract's f64 Gram, "
          f"{e_o:.3e} from the other candidate's (margin {margin:g})")
    _check(f"{name} ({what})", "Gram against its f64 sum", e_c, GRAM_RTOL)
    if not margin * e_c < e_o:
        raise AssertionError(f"{name} ({what}): the Gram is {e_c:.3e} from its contract "
                             f"and {e_o:.3e} from the other candidate (margin {margin:g})")


def gram_contract(torch, op, M1, M2, B1, B2, margin: float, label: str) -> None:
    """Each fused Gram of the bf16 path against the f64 Gram of the operands
    its contract names and of the other candidate: row 2's X Y^T of its
    unrounded f32 sums (the f32 kernel on the same values), not of the
    stored bf16 Y; rows 7 and 8's Y Y^T of the stored Y, not of the f32
    sums; row 5's U V^T and U U^T (the symmetric kernel the solvers run;
    no other candidate). e_c and e_o are relative Frobenius distances; the
    check needs e_c <= GRAM_RTOL and margin * e_c < e_o."""
    from blockcg_tpu_torch.ops import fused, stencil

    F1, F2 = B1.float(), B2.float()
    cases = (  # name, kernel, its output Y -> (contract, other) operand pairs
        ("stencil_spmm_gram_t[bf16]",
         lambda: stencil.stencil_spmm_gram_t(op.diags, op.offsets, B1),
         lambda Y: ((B1, stencil.stencil_spmm_t(op.diags.float(), op.offsets, F1)), (B1, Y))),
        ("gram[bf16]", lambda: (None, fused.gram(B1, B2)), lambda Y: ((B1, B2), None)),
        ("gram[bf16] U is V", lambda: (None, fused.gram(B1, B1)), lambda Y: ((B1, B1), None)),
        ("mm_update_gram[bf16]", lambda: fused.mm_update_gram(M1, B1),
         lambda Y: ((Y, Y), (fused.mm_update(M1, F1),) * 2)),
        ("mm2_update_gram[bf16]", lambda: fused.mm2_update_gram(M1, B1, M2, B2),
         lambda Y: ((Y, Y), (fused.mm2_update_gram(M1, F1, M2, F2)[0],) * 2)),
    )
    for name, kern, pairs in cases:
        Y, G = kern()
        contract_distance(torch, "[config5]", name, label, G, *pairs(Y), margin)
        del Y, G


def phase_config5_kernels(torch, dev, records) -> None:
    """``[config5] kernels``: each bf16 variant against its plain version at
    config 5's inner shape, (32, 256^3), on the 7-point operator in bf16; a
    stored bf16 element within ``BF16_ULPS`` of the plain version's, a Gram
    within ``C5_GRAM_RTOL`` of it and, through ``gram_contract``, nearer the
    f64 Gram its contract names than the other candidate's, at this shape
    and (by ``GRAM_MARGIN``) on the ``CONFIG5_CUT`` grid. Times (event
    medians: every launch here takes milliseconds) of the variant, its plain
    version, the f32 kernel on the same values in f32 and the library call,
    and the bound of the bf16 contract. Row 5 runs twice: U V^T, and U U^T,
    the symmetric kernel that SBCGrQ's Gram launches on the lean path, held
    also to exact symmetry; the record of ``gram[bf16]`` is the symmetric
    kernel's, beside its launches."""
    from blockcg_tpu_torch.ops import fused, stencil
    from blockcg_tpu_torch.problems import laplacian_dia

    bf = torch.bfloat16
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False  # bf16 GEMM: f32 sums
    op = laplacian_dia(CONFIG5_SHAPE, dtype=bf, device=dev)
    n, k = op.n, CONFIG5_KB
    gen = torch.Generator(device=dev).manual_seed(5)
    M1, M2, M3 = (torch.randn((k, k), generator=gen, device=dev) / k ** 0.5 for _ in range(3))
    B1, B2, B3 = (torch.randn((k, n), generator=gen, device=dev).to(bf) for _ in range(3))
    F1, F2, F3 = (B.float() for B in (B1, B2, B3))  # the same values for the f32 kernels
    d32 = op.diags.float()
    fb, gb, sf = nbytes(B1), k * k * 4, syrk_flops(k, n)
    what = f"n={n} k={k} bf16"

    def ulps(got, want):
        return bf16_ulps(torch, got, want)

    G64 = B1.double() @ B2.double().T
    print(f"[plan] stencil_spmm_t[bf16] {what}: " + "; ".join(
        stencil.describe(plan) for _, plan in stencil.launch_plans(op.diags, op.offsets, B1,
                                                                    False)))
    Y = stencil.stencil_spmm_t(op.diags, op.offsets, B1)
    csr, why = _dia_csr_library(torch, op.diags, op.offsets, B1, Y, ulps)
    _library_note(f"stencil_spmm_t[bf16] {what} (torch CSR @ dense, bf16; error in bf16 ulps "
                  f"of the kernel's Y)", why)
    mmf, why = _library_check(torch, lambda: torch.mm(B1, B2.T, out_dtype=torch.float32),
                              G64, "bf16 mm with out_dtype=float32 (relative Frobenius "
                              "error against the f64 Gram)", lambda g, w: relfro(g.double(), w))
    _library_note(f"gram[bf16] {what} (torch.mm, f32 out)", why)
    G64s = B1.double() @ B1.double().T
    mms, why = _library_check(torch, lambda: torch.mm(B1, B1.T, out_dtype=torch.float32),
                              G64s, "bf16 mm of U U^T with out_dtype=float32 (relative "
                              "Frobenius error against the f64 Gram)",
                              lambda g, w: relfro(g.double(), w))
    _library_note(f"gram[bf16] U is V {what} (torch.mm, f32 out)", why)
    G, Gs = fused.gram(B1, B2), fused.gram(B1, B1)
    Pn, Xn = fused.px_update(M1, B1, M2, B2, M3, B3)
    Pp, Xp = fused.px_update_plain(M1, B1, M2, B2, M3, B3)
    accuracy = {"px_update[bf16]": f"{max(ulps(Pn, Pp), ulps(Xn, Xp)):.2f} bf16 ulps from the "
                                   "plain version",
                "gram[bf16]": f"{relfro(G.double(), G64):.3e} from the f64 Gram",
                "gram[bf16] U is V": f"{relfro(Gs.double(), G64s):.3e} from the f64 Gram",
                "mm_update[bf16]": f"{ulps(fused.mm_update(M1, B1), fused.mm_update_plain(M1, B1)):.2f}"
                                   " bf16 ulps from the plain version"}
    _check(f"gram[bf16] ({what})", "Gram against its f64 sum", relfro(G.double(), G64), GRAM_RTOL)
    _check(f"gram[bf16] U is V ({what})", "Gram against its f64 sum",
           relfro(Gs.double(), G64s), GRAM_RTOL)
    if not torch.equal(Gs, Gs.T):
        raise AssertionError(f"gram[bf16] U is V ({what}): the Gram is not exactly symmetric "
                             f"(max |G - G^T| {float((Gs - Gs.T).abs().max()):.3e})")
    print(f"[config5] kernels gram[bf16] U is V {what}: exactly symmetric")
    del G, Gs, Pn, Xn, Pp, Xp
    # The Grams of rows 2, 7 and 8 against the f64 Gram of their contracts'
    # operands; rows 7 and 8's exactly symmetric.
    Yst, G = stencil.stencil_spmm_gram_t(op.diags, op.offsets, B1)
    S32 = stencil.stencil_spmm_t(op.diags.float(), op.offsets, F1)
    accuracy["stencil_spmm_gram_t[bf16]"] = (
        f"{relfro(G.double(), B1.double() @ S32.double().T):.3e} from the f64 Gram of its "
        "contract")
    del Yst, S32
    for name, Yg, G in (("mm_update_gram[bf16]", *fused.mm_update_gram(M1, B1)),
                        ("mm2_update_gram[bf16]", *fused.mm2_update_gram(M1, B1, M2, B2))):
        accuracy[name] = (f"{relfro(G.double(), Yg.double() @ Yg.double().T):.3e} from the f64 "
                          "Gram of its contract")
        if not torch.equal(G, G.T):
            raise AssertionError(f"{name} ({what}): the Gram is not exactly symmetric "
                                 f"(max |G - G^T| {float((G - G.T).abs().max()):.3e})")
        print(f"[config5] kernels {name} {what}: exactly symmetric")
    del Yg, G
    Mb = M1.to(bf)  # the rounded coefficient: bf16 GEMM with f32 accumulation
    mmb, why = _library_check(torch, lambda: Mb @ B1, fused.mm_update(M1, B1),
                              "bf16 GEMM (bf16 ulps of the kernel's Y)", ulps)
    _library_note(f"mm_update[bf16] {what} (bf16 M @ B)", why)
    for name in ("stencil_spmm_gram_t[bf16]", "mm_update_gram[bf16]", "mm2_update_gram[bf16]",
                 "px_update[bf16]"):
        _library_note(f"{name} {what}", "no single PyTorch call computes the fused outputs")
    del Y, G64, G64s
    cases = [  # name, kernel, plain, f32 kernel, (bytes, FLOPs), library, record key
        ("stencil_spmm_t[bf16]",
         lambda: (stencil.stencil_spmm_t(op.diags, op.offsets, B1),),
         lambda: (stencil.stencil_spmm_plain(op.diags, op.offsets, B1)[0],),
         lambda: stencil.stencil_spmm_t(d32, op.offsets, F1),
         (nbytes(op.diags) + 2 * fb, 2 * k * nnz(op.diags)), csr),
        ("stencil_spmm_gram_t[bf16]",
         lambda: stencil.stencil_spmm_gram_t(op.diags, op.offsets, B1),
         lambda: stencil.stencil_spmm_plain(op.diags, op.offsets, B1, True),
         lambda: stencil.stencil_spmm_gram_t(d32, op.offsets, F1),
         # X Y^T is not symmetric: 2 k^2 FLOPs a column
         (nbytes(op.diags) + 2 * fb + gb, 2 * k * nnz(op.diags) + 2 * k * k * n), None),
        ("gram[bf16]", lambda: (fused.gram(B1, B2),), lambda: (fused.gram_plain(B1, B2),),
         lambda: fused.gram(F1, F2), (2 * fb + gb, 2 * k * k * n), mmf),
        # U U^T reads one field and computes the entries on and above the
        # diagonal
        ("gram[bf16] U is V", lambda: (fused.gram(B1, B1),), lambda: (fused.gram_plain(B1, B1),),
         lambda: fused.gram(F1, F1), (fb + gb, sf), mms),
        ("mm_update[bf16]", lambda: (fused.mm_update(M1, B1),),
         lambda: (fused.mm_update_plain(M1, B1),), lambda: fused.mm_update(M1, F1),
         (nbytes(M1) + 2 * fb, 2 * n * nnz(M1)), mmb),
        ("mm_update_gram[bf16]", lambda: fused.mm_update_gram(M1, B1),
         lambda: fused.mm_update_gram_plain(M1, B1), lambda: fused.mm_update_gram(M1, F1),
         (nbytes(M1) + 2 * fb + gb, 2 * n * nnz(M1) + sf), None),
        ("mm2_update_gram[bf16]", lambda: fused.mm2_update_gram(M1, B1, M2, B2),
         lambda: fused.mm2_update_gram_plain(M1, B1, M2, B2),
         lambda: fused.mm2_update_gram(M1, F1, M2, F2),
         (nbytes(M1, M2) + 3 * fb + gb, 2 * n * nnz(M1, M2) + sf), None),
        ("px_update[bf16]", lambda: fused.px_update(M1, B1, M2, B2, M3, B3),
         lambda: fused.px_update_plain(M1, B1, M2, B2, M3, B3),
         lambda: fused.px_update(M1, F1, M2, F2, M3, F3),
         (nbytes(M1, M2, M3) + 5 * fb, 2 * n * nnz(M1, M2, M3)), None),
    ]
    # The wrapper's record: the symmetric Gram's for gram[bf16], as the
    # solvers launch it; the U V^T case is printed alone.
    keys = {"gram[bf16]": None, "gram[bf16] U is V": "gram[bf16]"}
    for name, kern, plain, f32, work, library in cases:
        err, abs_err = bf16_compare(torch, name, what, kern(), plain(), C5_GRAM_RTOL)
        ms, plain_ms, f32_ms = (median_ms(torch, fn) for fn in (kern, plain, f32))
        bound, by = bound_ms(*work, BF16_FLOPS)
        lib_ms = None if library is None else median_ms(torch, library)
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"[config5] kernels {name} {what}: max err {err:.2e} (ulps of a field, "
              f"rel Frobenius of a Gram; max abs {abs_err:.2e}), kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, f32 kernel {f32_ms:.4f} ms, bound {bound:.4f} ms ({by}: "
              f"{work[0] / 1e6:.1f} MB, {work[1] / 1e9:.2f} GFLOP), library {lib}")
        key = keys.get(name, name)
        if key is not None:
            records[key] = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
        if name in TENSOR_CORE_ROWS_BEFORE:
            old_ms, old_acc = TENSOR_CORE_ROWS_BEFORE[name]
            print(f"[config5] tensor cores {name} {what}: {accuracy[name]}, kernel {ms:.4f} ms, "
                  f"library {lib:s}; the f32-FMA kernel it replaced: {old_acc}, {old_ms:.4f} ms")
        elif name in accuracy:
            print(f"[config5] tensor cores {name} {what}: {accuracy[name]}, kernel {ms:.4f} ms, "
                  f"library {lib:s}")
    del cases, F1, F2, F3, d32, csr, mmf, mms, mmb
    gram_contract(torch, op, M1, M2, B1, B2, 1.0, what)
    del op, B1, B2, B3
    op = laplacian_dia(CONFIG5_CUT, dtype=bf, device=dev)
    B1, B2 = (torch.randn((k, op.n), generator=gen, device=dev).to(bf) for _ in range(2))
    gram_contract(torch, op, M1, M2, B1, B2, GRAM_MARGIN, f"n={op.n} k={k} bf16")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced


def relres_by_columns(torch, op, X, B, step: int = 8) -> float:
    """max_j ||B e_j - A X e_j|| / ||B e_j|| in f64 on the card, ``step``
    columns at a time (B and X (n, k), any float dtype)."""
    from blockcg_tpu_torch.operators import astype

    op64 = astype(op, torch.float64)
    worst = 0.0
    for j in range(0, X.shape[1], step):
        B64 = B[:, j:j + step].double()
        R = B64 - op64.matmat(X[:, j:j + step].double())
        worst = max(worst, float((torch.linalg.vector_norm(R, dim=0)
                                  / torch.linalg.vector_norm(B64, dim=0)).max()))
    return worst


def phase_config5_lean(torch, dev) -> tuple[dict, float, object]:
    """``[config5] lean``: ``solve_refined_lean`` on the bf16 config-5 preset
    at full size (B regenerated from ``CONFIG5_SEED``; the preset's own B is
    dropped), inner slices of 32, tol 1e-6. The launch counts are set to 0
    just before the solve and read just after; the peak is of allocated
    memory over the solve, its operator included. The true relres is taken
    in f64 against the regenerated B once the solve has returned. Returns
    (launch counts, peak GiB, the operator)."""
    from blockcg_tpu_torch import solve_refined_lean
    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.problems import config5_sbcgrq_3d_256
    from blockcg_tpu_torch.solvers import refine

    (op, B, meta), build_s = _timed(
        torch, lambda: config5_sbcgrq_3d_256(dtype=torch.bfloat16, device=dev))
    del B
    torch.cuda.empty_cache()
    inner, impl = [], refine._sbcgrq_impl

    def counted(*args, **kw):  # the inner solves' iterations, for the record
        X, info = impl(*args, **kw)
        inner.append(info.iterations)
        return X, info

    refine._sbcgrq_impl = counted
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _native.reset_launches()
        t0 = time.perf_counter()
        X, info = solve_refined_lean(op, CONFIG5_SEED, CONFIG5_K, tol=CONFIG5_TOL,
                                     inner_block=CONFIG5_KB, verbose=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_native.launches)
        routes = dict(_native.functions)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        refine._sbcgrq_impl = impl
    B = refine.lean_rhs(CONFIG5_SEED, CONFIG5_K, op.n, torch.bfloat16, dev).T
    rel = relres_by_columns(torch, op, X, B)
    bf16 = {w: counts.get(w, 0) for w in BF16_KERNELS}
    print(f"[config5] lean {meta['name']} n={op.n} k={CONFIG5_K} bf16 (built in {build_s:.1f} "
          f"s) solve_refined_lean tol={CONFIG5_TOL:g} inner_block={CONFIG5_KB}: "
          f"{info.iterations} cycles, {info.matvecs} matvecs, {sum(inner)} inner iterations "
          f"{inner}, {secs:.3f} s, true f64 relres {rel:.3e}, peak allocated {peak:.2f} GiB, "
          f"bf16 launches {bf16}")
    if not (bool(info.converged.all()) and rel <= CONFIG5_TOL):
        raise AssertionError(f"[config5] lean: true relres {rel:.3e}, not {CONFIG5_TOL:g}: {info}")
    if not peak <= CONFIG5_PEAK_GIB:
        raise AssertionError(f"[config5] lean: peak {peak:.2f} GiB > {CONFIG5_PEAK_GIB} GiB")
    # Row 1b's launches on the path take the ring of planes (stencil_ring).
    ring = routes.get("bcg_stencil_ring_bf16", 0)
    print(f"[config5] lean routes: stencil_spmm_t[bf16] {counts.get('stencil_spmm_t[bf16]', 0)} "
          f"launches, {ring} on the ring (bcg_stencil_ring_bf16)")
    if not 0 < ring == counts.get("stencil_spmm_t[bf16]", 0):
        raise AssertionError(f"[config5] lean: stencil_spmm_t[bf16] launched the ring {ring} of "
                             f"{counts.get('stencil_spmm_t[bf16]', 0)} times: {routes}")
    return counts, peak, op


def phase_config5_qr2(torch, dev, op) -> int:
    """``[config5] qr2``, row 7's own path: at ``qr_passes=1`` row 7 runs only
    in the adaptive second QR pass (where kappa_1 of an equilibrated Gram
    passes 0.5 / sqrt(eps_f32)), which the lean solve may never take. So the
    lean route's first inner solve (the first 32 columns of cycle 0's
    right-hand sides, unit columns) runs through ``solve_sbcgrq`` at
    ``qr_passes=2``, which takes row 7 every iteration, beside the same solve
    at ``qr_passes=1``. The second pass changes rounding alone: the two
    solves must take the same iterations within ``QR2_ITERS`` (at least 3)
    and reach the same true relres within a factor ``QR2_RELRES``; a wrong
    row 7 breaks the basis and the solve with it. Returns row 7's launches
    in the ``qr_passes=2`` solve, the counts set to 0 just before it."""
    from blockcg_tpu_torch import solve_sbcgrq
    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.solvers import refine

    Bs = refine.lean_rhs(CONFIG5_SEED, CONFIG5_K, op.n, torch.bfloat16, dev)[:CONFIG5_KB].float()
    Bs = (Bs / torch.linalg.vector_norm(Bs, dim=1, keepdim=True)).to(torch.bfloat16).T
    runs = {}
    for passes in (1, 2):
        _native.reset_launches()
        (X, info), secs = _timed(torch, lambda: solve_sbcgrq(op, Bs, tol=CONFIG5_INNER_TOL,
                                                             qr_passes=passes))
        row7 = _native.launches["mm_update_gram[bf16]"]
        rel = relres_by_columns(torch, op, X, Bs)
        print(f"[config5] qr2: the lean route's first inner solve (solve_sbcgrq, bf16, k="
              f"{CONFIG5_KB}, tol {CONFIG5_INNER_TOL:g}) at qr_passes={passes}: "
              f"{info.iterations} iterations, {secs:.3f} s, monitor "
              f"{float(info.relres.max()):.3e}, true f64 relres {rel:.3e}, "
              f"mm_update_gram[bf16] launches {row7}")
        if not bool(info.converged.all()):
            raise AssertionError(f"[config5] qr2: qr_passes={passes} did not converge: {info}")
        runs[passes] = (info.iterations, rel, row7)
        del X
    (it1, rel1, _), (it2, rel2, row7) = runs[1], runs[2]
    if not abs(it2 - it1) <= max(3, QR2_ITERS * it1):
        raise AssertionError(f"[config5] qr2: {it2} iterations at qr_passes=2, {it1} at 1")
    if not 1 / QR2_RELRES <= rel2 / rel1 <= QR2_RELRES:
        raise AssertionError(f"[config5] qr2: true relres {rel2:.3e} at qr_passes=2, "
                             f"{rel1:.3e} at 1")
    return row7


def phase_config5_f32(torch, dev, lean_peak: float) -> None:
    """``[config5] f32``: ``solve_refined`` (f64 outer, SBCGrQ inner at
    qr_passes=2, its defaults) on the f32 config-5 preset to tol 1e-6, beside
    the lean route's peak."""
    from blockcg_tpu_torch import solve_refined, solve_sbcgrq
    from blockcg_tpu_torch.ops import _native, stencil
    from blockcg_tpu_torch.problems import config5_sbcgrq_3d_256

    (op, B, meta), build_s = _timed(torch, lambda: config5_sbcgrq_3d_256(device=dev))
    inner = []

    def solve_fn(o, r, t):  # solve_refined's default inner solve, counted
        X, info = solve_sbcgrq(o, r, tol=t, max_iter=2000, qr_passes=2)
        inner.append(info.iterations)
        return X, info

    # Row 2 at the inner solves' 64 rows against its plain version, on a
    # random field of their shape (the kernels line keeps row 2's first
    # check, the north star's).
    X = torch.randn(B.T.shape, generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev)
    nnz_ = int(torch.count_nonzero(op.diags))
    k, n = X.shape
    _timed_check(torch, "stencil_spmm_gram_t", f"[config5] f32 ({k}, {n})",
                 lambda: stencil.stencil_spmm_gram_t(op.diags, op.offsets, X),
                 lambda: stencil.stencil_spmm_plain(op.diags, op.offsets, X, with_gram=True),
                 lambda w: w.shape[0] == w.shape[1], {},
                 work=(4 * op.diags.numel() + 8 * k * n + 4 * k * k,
                       2 * k * nnz_ + 2 * k * k * n))
    del X
    torch.cuda.empty_cache()
    # Row 2 in the inner solves: its plan's one launch of the window kernel's
    # Gram form (stencil_vec_gram, no cross blocks); every Gram apply
    # counted, so a launch on another route fails the check below.
    plans = stencil.launch_plans(op.diags, op.offsets, B.T, True)  # (k, n): its shape, dtype
    print(f"[plan] stencil_spmm_gram_t ({B.shape[1]}, {op.n}): {len(plans)} launches "
          f"{[rows for rows, _ in plans]}: "
          + "; ".join(stencil.describe(plan) for _, plan in plans))
    applies = []
    gram_apply = op.matmat_gram_t
    op.matmat_gram_t = lambda Xt: (applies.append(Xt.shape[0]), gram_apply(Xt))[1]
    _native.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (X, info), secs = _timed(torch, lambda: solve_refined(op, B, tol=CONFIG5_TOL,
                                                          solve_fn=solve_fn))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launched = (_native.launches["stencil_spmm_gram_t"],
                _native.functions["bcg_stencil_vec_gram"])
    want = [stencil.vec_gram_takes(r1 - r0) for k in applies
            for (r0, r1) in _native.row_chunks(k)]
    print(f"[config5] f32 row 2: {len(applies)} Gram applies, {launched[0]} launches of "
          f"stencil_spmm_gram_t (the plan's {len(want)}), {launched[1]} of them "
          f"stencil_vec_gram (the plan's {sum(want)})")
    if not (0 < sum(want) and launched == (len(want), sum(want))):
        raise AssertionError(f"[config5] f32: row 2 launched {launched[0]} times for "
                             f"{len(applies)} applies ({len(want)} on its chunks), "
                             f"stencil_vec_gram {launched[1]} times ({sum(want)})")
    rel = relres_by_columns(torch, op, X, B)
    print(f"[config5] f32 {meta['name']} n={op.n} k={B.shape[1]} (built in {build_s:.1f} s) "
          f"solve_refined tol={CONFIG5_TOL:g}: {info.iterations} cycles, {info.matvecs} "
          f"matvecs, {sum(inner)} inner iterations {inner}, {secs:.3f} s, true f64 relres "
          f"{rel:.3e}, peak allocated {peak:.2f} GiB (lean route {lean_peak:.2f} GiB)")
    if not (bool(info.converged.all()) and rel <= CONFIG5_TOL):
        raise AssertionError(f"[config5] f32: true relres {rel:.3e}, not {CONFIG5_TOL:g}: {info}")


def phase_bf16presets_kernels(torch, dev, records) -> None:
    """``[bf16presets] kernels``: the bf16 variants of rows 10, 12 and 13
    against their plain versions: ``xr_update_gram[bf16]`` at config 2's
    field (16, 512^2) and at config 4's merged (48, 32^4) on I_4 ⊗ C
    coefficients, ``qr_p_update[bf16]`` at (48, 32^4) and at m = 96,
    ``qr_px_update[bf16]`` at (48, 32^4) and, dense, at 16, 64 and 96 rows
    (``px_update_mma``'s QR-with-X mode up to 64 rows, one launch of the
    streaming kernel at 96: the route printed from ``_native.functions``),
    fresh and donated (the donated call in place, bitwise the fresh one).
    Fields within ``BF16_ULPS`` of the
    plain version's, the Gram within ``GRAM_RTOL`` of it and, by
    ``contract_distance``, nearer the f64 Gram of the stored bf16 Rn than of
    the unrounded f32 Rn (by ``GRAM_MARGIN`` at 512^2, by 1 at 32^4, as
    [config5] at its cut and at full size). Times (event medians) of the
    variant, its plain version and the f32 kernel on the same values; the
    first shape of each sets its record. No single PyTorch call computes any
    of the three fused functions."""
    from blockcg_tpu_torch.ops import _native, fused

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(14)
    for name in PRESETS_BF16:
        _library_note(name, "no single PyTorch call computes the fused outputs")

    def coeff(m, k):  # m x m: dense (k == m) or I_bs ⊗ C with C k x k
        C = torch.randn((k, k), generator=gen, device=dev) / k ** 0.5
        return C if k == m else torch.kron(torch.eye(m // k, device=dev), C)

    c4 = (PRESETS_DIRAC_K, DIRAC_K, DIRAC_L ** 4)
    cases = (  # name, label, (m, k of C, n), Gram margin
        ("xr_update_gram[bf16]", "config 2", (*PRESETS_BCG_SHAPE[:1], *PRESETS_BCG_SHAPE),
         GRAM_MARGIN),
        ("xr_update_gram[bf16]", "config 4", c4, 1.0),
        ("qr_p_update[bf16]", "config 4", c4, None),
        ("qr_p_update[bf16]", f"m = {WIDE_M}", (WIDE_M, WIDE_M // 4, DIRAC_L ** 4), None),
        ("qr_px_update[bf16]", "config 4", c4, None),
        *(("qr_px_update[bf16]", f"{m} rows", (m, m, DIRAC_L ** 4), None)
          for m in QR_PX_BF16_ROWS),
    )
    for name, label, (m, k, n), margin in cases:
        A1, A2, A3 = (coeff(m, k) for _ in range(3))
        F = [torch.randn((m, n), generator=gen, device=dev).to(bf) for _ in range(4)]
        F32 = [f.float() for f in F]
        fb = nbytes(F[0])
        if name.startswith("xr_update_gram"):
            print(f"[plan] {name} ({m}, {n}): {fused.xr_update_gram_plan(m, dev, 2)}")
            calls = (lambda: fused.xr_update_gram(A1, *F),
                     lambda: fused.xr_update_gram_plain(A1, *F),
                     lambda: fused.xr_update_gram(A1, *F32))
            work = (nbytes(A1) + 6 * fb + 4 * m * m, 4 * n * nnz(A1) + syrk_flops(m, n))
        elif name.startswith("qr_p_update"):
            calls = (lambda: fused.qr_p_update(A1, F[0], A2, F[1]),
                     lambda: fused.qr_p_update_plain(A1, F[0], A2, F[1]),
                     lambda: fused.qr_p_update(A1, F32[0], A2, F32[1]))
            work = (nbytes(A1, A2) + 4 * fb, 2 * n * nnz(A1, A2))
        else:
            calls = (lambda: fused.qr_px_update(A1, F[0], A2, F[1], A3, F[2]),
                     lambda: fused.qr_px_update_plain(A1, F[0], A2, F[1], A3, F[2]),
                     lambda: fused.qr_px_update(A1, F32[0], A2, F32[1], A3, F32[2]))
            work = (nbytes(A1, A2, A3) + 6 * fb, 2 * n * nnz(A1, A2, A3))
        what = f"{label} ({m}, {n}) bf16"
        before = dict(_native.functions)
        got = calls[0]()
        routes = {f: c - before.get(f, 0) for f, c in _native.functions.items()
                  if c != before.get(f, 0)}
        err, abs_err = bf16_compare(torch, name, what, got, calls[1](), GRAM_RTOL)
        if name.startswith("qr_px_update"):
            want = {"bcg_qr_px_update_mma" if m <= 64 else "bcg_qr_px_update_bf16": 1}
            bufs = [f.clone() for f in F[:3]]
            don = fused.qr_px_update(A1, bufs[0], A2, bufs[1], A3, bufs[2], donate=True)
            torch.cuda.synchronize()
            in_place = [d.data_ptr() for d in don] == [b.data_ptr() for b in bufs]
            print(f"[bf16presets] kernels {name} {what}: route {routes}, donated in place "
                  f"{in_place}, bitwise the fresh call "
                  f"{all(torch.equal(d, g) for d, g in zip(don, got))}")
            if routes != want or not in_place or not all(
                    torch.equal(d, g) for d, g in zip(don, got)):
                raise AssertionError(f"[bf16presets] {name} {what}: route {routes} (want "
                                     f"{want}), donated in place {in_place}")
            del bufs, don
        if margin is not None:  # the Gram of the stored Rn, not of the f32 sums
            Rn32 = calls[2]()[1]
            contract_distance(torch, "[bf16presets]", name, what, got[2], (got[1], got[1]),
                              (Rn32, Rn32), margin)
            del Rn32
        del got
        ms, plain_ms, f32_ms = (median_ms(torch, fn) for fn in calls)
        bound, by = bound_ms(*work, BF16_FLOPS)
        print(f"[bf16presets] kernels {name} {what}: max err {err:.2e} (ulps of a field, rel "
              f"Frobenius of a Gram; max abs {abs_err:.2e}), kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, f32 kernel {f32_ms:.4f} ms, bound {bound:.4f} ms ({by}: "
              f"{work[0] / 1e6:.1f} MB, {work[1] / 1e9:.2f} GFLOP), library none")
        rec = records.setdefault(name, {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                        "bound_ms": bound, "bound_by": by, "library_ms": None})
        rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
        del F, F32, calls
        torch.cuda.empty_cache()


def _bf16_solve(torch, tag, op, B, solve) -> None:
    """One plain bf16 solve of [bf16presets]: X must come back bf16 and
    finite; prints iterations, convergence, the monitor, the true f64
    relres and the seconds."""
    (X, info), secs = _timed(torch, solve)
    if X.dtype != torch.bfloat16 or not bool(torch.isfinite(X).all()):
        raise AssertionError(f"[bf16presets] {tag}: X is {X.dtype}, finite "
                             f"{bool(torch.isfinite(X).all())}, monitor {info.relres}")
    rel = relres_by_columns(torch, op, X.reshape(op.n, -1), B.reshape(op.n, -1))
    print(f"[bf16presets] {tag}: {info.iterations} iterations, converged "
          f"{bool(info.converged.all())}, monitor {float(info.relres.max()):.3e}, true f64 "
          f"relres {rel:.3e}, {secs:.3f} s, X bf16, finite")


def _bf16_refined(torch, tag, op, B, inner: str) -> None:
    """``bench_cli.py --dtype bf16 --refined``: ``solve_refined`` on the bf16
    operator and the f32 B (the bf16 preset's values), the f64 outer loop,
    inner_tol 5e-3, up to ``PRESETS_CYCLES`` cycles (each printed). X must
    come back f64 and finite, within a true f64 relres of ``PRESETS_TOL``."""
    from blockcg_tpu_torch import solve_refined

    B32 = B.float()
    (X, info), secs = _timed(torch, lambda: solve_refined(
        op, B32, tol=PRESETS_TOL, inner_tol=PRESETS_INNER_TOL, inner_solver=inner,
        max_cycles=PRESETS_CYCLES, verbose=True))
    if X.dtype != torch.float64 or not bool(torch.isfinite(X).all()):
        raise AssertionError(f"[bf16presets] {tag} --refined: X is {X.dtype}, finite "
                             f"{bool(torch.isfinite(X).all())}")
    rel = relres_by_columns(torch, op, X, B32)
    print(f"[bf16presets] {tag} --refined (inner {inner}, inner_tol {PRESETS_INNER_TOL:g}): "
          f"{info.iterations} cycles, {info.matvecs} matvecs, {secs:.3f} s, true f64 relres "
          f"{rel:.3e}")
    if not (bool(info.converged.all()) and rel <= PRESETS_TOL):
        raise AssertionError(f"[bf16presets] {tag} --refined: true relres {rel:.3e}, not "
                             f"{PRESETS_TOL:g}: {info}")


def phase_bf16presets(torch, dev) -> dict:
    """``[bf16presets]``: configs 1-4 in bf16 at full size, as ``bench_cli.py
    --dtype bf16`` runs them (tol 1e-6, max_iter 2000): CG on config 1's
    column 0, BCG, BCGA and BCGdQ on config 2, SBCGrQ on configs 3 and 4,
    each beside its ``--refined`` run (inner BCG on config 2, SBCGrQ on the
    others). The launch counts are set to 0 before each configuration and
    read after it; config 4's const-hop kernels must launch no time (bf16
    fields take the plain route). Returns config 2's counts, the path of
    ``xr_update_gram[bf16]``."""
    from blockcg_tpu_torch import solve_bcg, solve_bcga, solve_bcgdq, solve_cg, solve_sbcgrq
    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.problems import presets

    bf = torch.bfloat16
    kw = dict(tol=PRESETS_TOL, max_iter=PRESETS_MAX_ITER)
    t0 = time.perf_counter()

    def column0(B):
        return B[:, 0]

    runs = (  # preset, plain solves (name, solver, its RHS), --refined's inner solver,
        # the kernels the configuration must launch
        (presets.config1_cg_2d_128, (("solve_cg column 0", solve_cg, column0),), "sbcgrq",
         ("stencil_spmm_gram_t[bf16]",)),
        (presets.config2_bcg_2d_512, (("solve_bcg", solve_bcg, None),
                                      ("solve_bcga", solve_bcga, None),
                                      ("solve_bcgdq", solve_bcgdq, None)), "bcg",
         ("stencil_spmm_gram_t[bf16]", "xr_update_gram[bf16]", "gram[bf16]", "mm_update[bf16]",
          "mm_update_gram[bf16]")),
        (presets.config3_sbcgrq_3d_64, (("solve_sbcgrq", solve_sbcgrq, None),), "sbcgrq",
         ("stencil_spmm_gram_t[bf16]", "gram[bf16]", "mm2_update_gram[bf16]",
          "px_update[bf16]")),
        (presets.config4_dirac_32, (("solve_sbcgrq", solve_sbcgrq, None),), "sbcgrq",
         ("gram[bf16]", "mm2_update_gram[bf16]", "px_update[bf16]")),
    )
    counts2 = None
    for preset, plain, inner, wrappers in runs:
        op, B, meta = preset(dtype=bf, device=dev)
        tag = f"{meta['name']} n={op.n} k={B.shape[1]} bf16"
        _native.reset_launches()
        for name, fn, rhs in plain:
            Bs = B if rhs is None else rhs(B)
            _bf16_solve(torch, f"{tag} {name}", op, Bs, lambda: fn(op, Bs, **kw))
        _bf16_refined(torch, tag, op, B, inner)
        got = dict(_native.launches)
        print(f"[launches] bf16 {meta['name']}: {got}")
        missing = [w for w in wrappers if got.get(w, 0) == 0]
        if missing:
            raise AssertionError(f"[bf16presets] {meta['name']} never launched {missing}")
        if preset is presets.config2_bcg_2d_512:
            counts2 = got
        if preset is presets.config4_dirac_32:
            hops = {w: got.get(w, 0) for w in CONST_HOP_KERNELS}
            print(f"[bf16presets] {meta['name']} const-hop launches {hops}: 0 by the dtype "
                  "rule (ops/_native.py f32_gate_refuses, read by ConstBlockDIAOperator."
                  "_apply: a bf16 field takes the whole plain roll-and-einsum, so no "
                  "const-hop wrapper is called, as the reference's gate "
                  "blockcg_tpu/operators/cbdia.py:133-141 takes float32 alone)")
            if any(hops.values()):
                raise AssertionError(f"[bf16presets] bf16 config 4 launched {hops}")
        del op, B
        torch.cuda.empty_cache()
    print(f"[wall] [bf16presets] solves {time.perf_counter() - t0:.1f} s")
    return counts2


def _fold_env(on: bool) -> None:
    """Set or clear ``BLOCKCG_FOLD``, which the builders read when they build
    and ``BlockDIAOperator`` when it applies."""
    import os

    if on:
        os.environ["BLOCKCG_FOLD"] = "1"
    else:
        os.environ.pop("BLOCKCG_FOLD", None)


def require_launches(label: str, counts: dict, wrappers) -> None:
    """Raise unless each of ``wrappers`` launched on the path of ``label``."""
    missing = [w for w in wrappers if counts.get(w, 0) == 0]
    if missing:
        raise AssertionError(f"{label} never launched the kernels of {missing}")


def _bf16_record(torch, records, name, what, kern, plain, timed, work, rate, gram_rtol,
                 library=None):
    """A variant with a bf16 output against its plain version
    (``bf16_compare``), timed beside it and beside ``library`` (one PyTorch
    call computing the same function, or None); prints one line and sets
    the record. ``timed``: the two calls to time (the variant's and the
    plain version's)."""
    err, abs_err = bf16_compare(torch, name, what, kern(), plain(), gram_rtol)
    ms, plain_ms = (median_ms(torch, fn) for fn in timed)
    bound, by = bound_ms(*work, rate)
    lib_ms = None if library is None else median_ms(torch, library)
    print(f"[kernel] {name} {what}: max err {err:.2e} (bf16 ulps of a field, rel Frobenius "
          f"of a Gram; max abs {abs_err:.2e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound:.4f} ms ({by}: {work[0] / 1e6:.1f} MB, {work[1] / 1e9:.2f} GFLOP), "
          f"library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    records[name] = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


def phase_storage_kernels(torch, dev, records, op) -> None:
    """``[storage] kernels``: the new variants against their plain versions at
    the main path's shapes. On ``dirac_gauged_matrix(32)`` at k = 12 (m =
    48): bf16 blocks with f32 X (rows 22h, 23h), also bitwise the f32 kernel
    on the blocks lifted to f32; the folded blocks (9 of 15 diagonals) with
    and without the Gram (24f, 24fg), within FIELD_RTOL of the unfolded
    kernel, and with bf16 folded blocks (bitwise the f32 folded kernel on
    their lift); each unfolded apply timed beside. On the 128^3 Laplacian at
    k = 32: both mixed stencil pairs (rows 1m, 2m with bf16 diagonals, 1x, 2x
    with a bf16 field), bitwise the unmixed kernels (the Laplacian's
    entries are exact in bf16); at k = 96 the bf16 stencil's wide Gram
    (``[bf16, wide]``), nearer the f64 Gram of its contract (X and the f32
    sums) than the stored Y's."""
    from blockcg_tpu_torch.ops import block_stencil as bsk
    from blockcg_tpu_torch.ops import stencil
    from blockcg_tpu_torch.problems import laplacian_dia

    bf = torch.bfloat16
    k, (nd, bs, _, ns) = ML_K, op.blocks.shape
    m = bs * k
    gen = torch.Generator(device=dev).manual_seed(15)
    Xm = torch.randn((m, ns), generator=gen, device=dev)
    Xv = torch.randn((k, bs, ns), generator=gen, device=dev)
    what = f"dirac_gauged_matrix({ML_L}) ns={ns} k={k} m={m}"

    def is_gram(w):
        return w.shape == (m, m)

    def same(name, label, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} ({what}): not bitwise {label}")
        print(f"[storage] {name}: bitwise {label}")

    b16, offs = op.blocks.to(bf), op.offsets
    lifted = b16.float()
    # One PyTorch call computing each: torch's BSR product of the blocks
    # lifted to f32 (the same linear map) times the site-major field.
    plan = bsk.launch_plans(b16, offs, k, False, dev, tma=bsk._tma_ok(b16, Xm))[0][1]
    print(f"[plan] block_stencil_spmm_m_t[bf16 coeffs] {what}: 1 launch: {plan.describe()}")
    Y = bsk.block_stencil_spmm_m_t(b16, offs, Xm)
    bsr, why = _site_bsr_library(torch, lifted, offs, Xm, Y)
    _library_note(f"block_stencil_spmm_m_t[bf16 coeffs] {what} (torch BSR @ dense of the "
                  "blocks lifted to f32)", why)
    _timed_check(torch, "block_stencil_spmm_m_t[bf16 coeffs]", what,
                 lambda: (bsk.block_stencil_spmm_m_t(b16, offs, Xm), None),
                 lambda: bsk.block_stencil_plain(b16, offs, Xm), is_gram, records,
                 work=(nbytes(b16, Xm, Xm), 2 * k * nnz(b16)), library=bsr)
    del bsr
    same("block_stencil_spmm_m_t[bf16 coeffs]", "the f32 kernel on the lifted blocks",
         bsk.block_stencil_spmm_m_t(b16, offs, Xm), bsk.block_stencil_spmm_m_t(lifted, offs, Xm))
    bsr, why = _site_bsr_library(torch, lifted, offs, Xv,
                                 bsk.block_stencil_spmm_t(b16, offs, Xv))
    _library_note(f"block_stencil_spmm_t[bf16 coeffs] ({k}, {bs}, {ns}) view (torch BSR @ "
                  "dense of the blocks lifted to f32)", why)
    _timed_check(torch, "block_stencil_spmm_t[bf16 coeffs]", f"({k}, {bs}, {ns}) view",
                 lambda: (bsk.block_stencil_spmm_t(b16, offs, Xv), None),
                 lambda: (bsk.block_stencil_v_plain(b16, offs, Xv), None), is_gram, records,
                 work=(nbytes(b16, Xv, Xv), 2 * k * nnz(b16)), library=bsr)
    del bsr
    vplans = bsk.launch_plans(b16, offs, k, False, dev, tma=bsk._tma_ok(b16, Xv))
    print(f"[plan] block_stencil_spmm_t[bf16 coeffs] ({k}, {bs}, {ns}) view: {len(vplans)} "
          "launch: " + "; ".join(plan.describe() for _, plan in vplans))
    if not all(plan.tma for _, plan in vplans):
        raise AssertionError("[storage] the (k, bs, ns) view on bf16 blocks left bs_tma")
    same("block_stencil_spmm_t[bf16 coeffs]", "the f32 kernel on the lifted blocks",
         bsk.block_stencil_spmm_t(b16, offs, Xv), bsk.block_stencil_spmm_t(lifted, offs, Xv))
    del lifted, Y

    fb, foffs, fold = op.blocks_folded, op.fold_offsets, op.fold
    print(f"[storage] folded: {len(foffs)} of {len(offs)} diagonals streamed, fold {fold}")
    for blocks, gram, name in ((fb, False, "block_stencil_spmm_m_t[fold]"),
                               (fb, True, "block_stencil_spmm_m_gram_t[fold]"),
                               (fb.to(bf), False, "block_stencil_spmm_m_t[fold, bf16 coeffs]")):
        plans = bsk.launch_plans(blocks, foffs, k, gram, dev, fold=fold,
                                 tma=bsk._tma_ok(blocks, Xm))
        print(f"[plan] {name} {what}: {len(plans)} launch: "
              + "; ".join(plan.describe() for _, plan in plans))
    Y = bsk.block_stencil_spmm_m_t(op.blocks, offs, Xm)
    bsr, why = _site_bsr_library(torch, op.blocks, offs, Xm, Y)
    _library_note(f"block_stencil_spmm_m_t[fold] {what} (torch BSR @ dense of the same "
                  f"matrix, unfolded)", why)
    _library_note("block_stencil_spmm_m_gram_t[fold]", "no single PyTorch call")
    apply_work = (nbytes(fb, Xm, Xm), 2 * k * nnz(fb))
    _timed_check(torch, "block_stencil_spmm_m_t[fold]", what,
                 lambda: (bsk.block_stencil_spmm_m_t(fb, foffs, Xm, fold), None),
                 lambda: bsk.block_stencil_plain(fb, foffs, Xm, False, fold), is_gram, records,
                 work=apply_work, library=bsr)
    del bsr
    _timed_check(torch, "block_stencil_spmm_m_gram_t[fold]", what,
                 lambda: bsk.block_stencil_spmm_m_gram_t(fb, foffs, Xm, fold),
                 lambda: bsk.block_stencil_plain(fb, foffs, Xm, True, fold), is_gram, records,
                 work=(apply_work[0] + m * m * 4, apply_work[1] + syrk_flops(m, ns)))
    Yg, Gg = bsk.block_stencil_spmm_m_gram_t(fb, foffs, Xm, fold)
    contract_distance(torch, "[storage]", "block_stencil_spmm_m_gram_t[fold]", what, Gg,
                      (Xm, Yg), None, 1.0)
    del Yg, Gg
    Yf = bsk.block_stencil_spmm_m_t(fb, foffs, Xm, fold)
    torch.cuda.synchronize()
    err = relmax(Yf, Y)
    _check("block_stencil_spmm_m_t[fold]", "against the unfolded kernel", err, FIELD_RTOL)
    fb16 = fb.to(bf)
    # Folding and rounding to bf16 commute (each site's block is one of the
    # pair's), so the unfolded matrix lifted to f32 is the same linear map.
    bsr, why = _site_bsr_library(torch, op.blocks.to(bf).float(), offs, Xm,
                                 bsk.block_stencil_spmm_m_t(fb16, foffs, Xm, fold))
    _library_note(f"block_stencil_spmm_m_t[fold, bf16 coeffs] {what} (torch BSR @ dense of the "
                  "unfolded matrix, lifted to f32)", why)
    _timed_check(torch, "block_stencil_spmm_m_t[fold, bf16 coeffs]", what,
                 lambda: (bsk.block_stencil_spmm_m_t(fb16, foffs, Xm, fold), None),
                 lambda: bsk.block_stencil_plain(fb16, foffs, Xm, False, fold), is_gram, records,
                 work=(nbytes(fb16, Xm, Xm), 2 * k * nnz(fb16)), library=bsr)
    del bsr
    same("block_stencil_spmm_m_t[fold, bf16 coeffs]", "the f32 folded kernel on the lift",
         bsk.block_stencil_spmm_m_t(fb16, foffs, Xm, fold),
         bsk.block_stencil_spmm_m_t(fb16.float(), foffs, Xm, fold))
    times = {label: median_ms(torch, fn) for label, fn in (
        ("unfolded", lambda: bsk.block_stencil_spmm_m_t(op.blocks, offs, Xm)),
        ("unfolded with Gram", lambda: bsk.block_stencil_spmm_m_gram_t(op.blocks, offs, Xm)),
        ("folded", lambda: bsk.block_stencil_spmm_m_t(fb, foffs, Xm, fold)),
        ("folded with Gram", lambda: bsk.block_stencil_spmm_m_gram_t(fb, foffs, Xm, fold)),
        ("bf16 blocks", lambda: bsk.block_stencil_spmm_m_t(b16, offs, Xm)),
        ("folded bf16 blocks", lambda: bsk.block_stencil_spmm_m_t(fb16, foffs, Xm, fold)))}
    print(f"[storage] {what} apply ms, one process: " +
          ", ".join(f"{label} {t:.4f}" for label, t in times.items()) +
          f"; folded vs unfolded rel err {err:.2e}")
    del Xm, Xv, Y, Yf, fb16, b16
    torch.cuda.empty_cache()

    lap = laplacian_dia(SHAPES[0], device=dev)
    n, kk = lap.n, K
    d32, d16 = lap.diags, lap.diags.to(bf)
    X32 = torch.randn((kk, n), generator=gen, device=dev)
    X16 = X32.to(bf)
    lw = f"n={n} k={kk}"

    def is_kk(w):
        return w.shape == (kk, kk)

    for name in STORAGE_STENCIL[1:2] + STORAGE_STENCIL[3:]:
        _library_note(name, "no PyTorch call takes a mixed bf16/f32 pair")
    csr, why = _dia_csr_library(torch, d16.float(), lap.offsets, X32,
                                stencil.stencil_spmm_t(d16, lap.offsets, X32))
    _library_note(f"stencil_spmm_t[bf16 coeffs] {lw} (torch CSR @ dense of the diagonals "
                  "lifted to f32)", why)
    sp_work = (nbytes(d16, X32, X32), 2 * kk * nnz(d16))
    _timed_check(torch, "stencil_spmm_t[bf16 coeffs]", f"{lw} bf16 diagonals, f32 X",
                 lambda: (stencil.stencil_spmm_t(d16, lap.offsets, X32),),
                 lambda: (stencil.stencil_spmm_plain(d16, lap.offsets, X32)[0],), is_kk,
                 records, work=sp_work, library=csr)
    del csr
    _timed_check(torch, "stencil_spmm_gram_t[bf16 coeffs]", f"{lw} bf16 diagonals, f32 X",
                 lambda: stencil.stencil_spmm_gram_t(d16, lap.offsets, X32),
                 lambda: stencil.stencil_spmm_plain(d16, lap.offsets, X32, True), is_kk,
                 records, work=(sp_work[0] + kk * kk * 4, sp_work[1] + 2 * kk * kk * n))
    Ym, Gm = stencil.stencil_spmm_gram_t(d16, lap.offsets, X32)
    Yu, Gu = stencil.stencil_spmm_gram_t(d32, lap.offsets, X32)
    same("stencil_spmm_gram_t[bf16 coeffs]", "the f32 kernel (Y and G)",
         torch.cat([Ym.reshape(-1), Gm.reshape(-1)]), torch.cat([Yu.reshape(-1), Gu.reshape(-1)]))
    # Rows 2m and 2 (stencil_mma_f32): G from its f32 sums, Y itself; no
    # other candidate Gram on an f32 field.
    for name, G, Yf in (("stencil_spmm_gram_t[bf16 coeffs]", Gm, Ym), ("stencil_spmm_gram_t", Gu,
                                                                        Yu)):
        contract_distance(torch, "[storage]", name, f"{lw} (the north star's field)", G,
                          (X32, Yf), None, 1.0)
    mplans = stencil.launch_plans(d16, lap.offsets, X32, False)
    print(f"[plan] stencil_spmm_t[bf16 coeffs] {lw} bf16 diagonals, f32 X: "
          + "; ".join(stencil.describe(plan) for _, plan in mplans))
    if not all(isinstance(plan, stencil.RingPlan) for _, plan in mplans):
        raise AssertionError(f"[storage] row 1m {lw}: not on the ring of planes")
    Y1m = stencil.stencil_spmm_t(d16, lap.offsets, X32)
    same("stencil_spmm_t[bf16 coeffs]", "the f32 kernel", Y1m, Yu)
    same("stencil_spmm_t[bf16 coeffs]", "the f32 diagonals' apply", Y1m,
         stencil.stencil_spmm_t(d32, lap.offsets, X32))
    del Y1m
    xw = (nbytes(d32, X16, X16), 2 * kk * nnz(d32))
    print(f"[plan] stencil_spmm_t[bf16 field] {lw} f32 diagonals, bf16 X: "
          + "; ".join(stencil.describe(plan)
                      for _, plan in stencil.launch_plans(d32, lap.offsets, X16, False)))
    # One PyTorch call: the CSR of the f32 diagonals times X lifted to f32
    # (lifted outside the timed call), its f32 result rounded to bf16 when
    # held to the kernel's Y.
    csr, why = _dia_csr_library(torch, d32, lap.offsets, X16.float(),
                                stencil.stencil_spmm_t(d32, lap.offsets, X16),
                                lambda g, w: bf16_ulps(torch, g.to(bf), w))
    _library_note(f"stencil_spmm_t[bf16 field] {lw} (torch CSR @ dense of the f32 diagonals and "
                  "X lifted to f32; error in bf16 ulps of the kernel's Y)", why)
    _bf16_record(torch, records, "stencil_spmm_t[bf16 field]", f"{lw} f32 diagonals, bf16 X",
                 lambda: (stencil.stencil_spmm_t(d32, lap.offsets, X16),),
                 lambda: (stencil.stencil_spmm_plain(d32, lap.offsets, X16)[0],),
                 (lambda: stencil.stencil_spmm_t(d32, lap.offsets, X16),
                  lambda: stencil.stencil_spmm_plain(d32, lap.offsets, X16)),
                 xw, F32_FLOPS, GRAM_RTOL, library=csr)
    del csr
    _bf16_record(torch, records, "stencil_spmm_gram_t[bf16 field]",
                 f"{lw} f32 diagonals, bf16 X",
                 lambda: stencil.stencil_spmm_gram_t(d32, lap.offsets, X16),
                 lambda: stencil.stencil_spmm_plain(d32, lap.offsets, X16, True),
                 (lambda: stencil.stencil_spmm_gram_t(d32, lap.offsets, X16),
                  lambda: stencil.stencil_spmm_plain(d32, lap.offsets, X16, True)),
                 (xw[0] + kk * kk * 4, xw[1] + 2 * kk * kk * n), F32_FLOPS, GRAM_RTOL)
    Yx, Gx = stencil.stencil_spmm_gram_t(d32, lap.offsets, X16)
    Yb, Gb = stencil.stencil_spmm_gram_t(d16, lap.offsets, X16)
    same("stencil_spmm_gram_t[bf16 field]", "the bf16 kernel (Y and G)",
         torch.cat([Yx.float().reshape(-1), Gx.reshape(-1)]),
         torch.cat([Yb.float().reshape(-1), Gb.reshape(-1)]))
    del Ym, Gm, Yu, Gu, Yx, Gx, Yb, Gb, X32, X16

    kw = STORAGE_WIDE_K
    W16 = torch.randn((kw, n), generator=gen, device=dev).to(bf)
    ww = f"n={n} k={kw} bf16"
    _library_note("stencil_spmm_gram_t[bf16, wide]", "no single PyTorch call")
    _bf16_record(torch, records, "stencil_spmm_gram_t[bf16, wide]", ww,
                 lambda: stencil.stencil_spmm_gram_t(d16, lap.offsets, W16),
                 lambda: stencil.stencil_spmm_plain(d16, lap.offsets, W16, True),
                 (lambda: stencil.stencil_spmm_gram_t(d16, lap.offsets, W16),
                  lambda: stencil.stencil_spmm_plain(d16, lap.offsets, W16, True)),
                 (nbytes(d16, W16, W16) + kw * kw * 4, 2 * kw * nnz(d16) + 2 * kw * kw * n),
                 BF16_FLOPS, C5_GRAM_RTOL)
    Yw, Gw = stencil.stencil_spmm_gram_t(d16, lap.offsets, W16)
    S = stencil.stencil_spmm_t(d32, lap.offsets, W16.float())  # the f32 sums, same order
    contract_distance(torch, "[storage]", "stencil_spmm_gram_t[bf16, wide]", ww, Gw,
                      (W16, S), (W16, Yw), 1.0)
    same("stencil_spmm_t[bf16]", f"the wide Gram's Y ({ww})", Yw,
         stencil.stencil_spmm_t(d16, lap.offsets, W16))
    Yx, Gx = stencil.stencil_spmm_gram_t(d32, lap.offsets, W16)
    same("stencil_spmm_gram_t[bf16 field, wide]", "the [bf16, wide] launches (Y and G)",
         torch.cat([Yx.float().reshape(-1), Gx.reshape(-1)]),
         torch.cat([Yw.float().reshape(-1), Gw.reshape(-1)]))
    # The route the column blocks replaced summed in f32 FMAs as the f32
    # kernel does on the lifted field (its launches' Grams and gram.cu's
    # cross blocks of X and the sums): its distance from the contract.
    G32 = stencil.stencil_spmm_gram_t(d32, lap.offsets, W16.float())[1]
    G64 = W16.double() @ S.double().T
    e_new, e_old = (relfro(g.double(), G64) for g in (Gw, G32))
    old_ms, old_what = STORAGE_WIDE_BEFORE
    print(f"[storage] tensor cores stencil_spmm_gram_t[bf16, wide] {ww}: "
          f"{records['stencil_spmm_gram_t[bf16, wide]']['ms']:.4f} ms in column blocks, its Gram "
          f"{e_new:.3e} from its contract's f64 Gram; the route it replaced: {old_ms:.4f} ms, "
          f"{old_what}, its f32 arithmetic {e_old:.3e} from it")
    del lap, W16, Yw, Gw, S, Yx, Gx, G32, G64
    torch.cuda.empty_cache()


def phase_storage(torch, dev, records) -> dict:
    """``[storage]``: bf16 block storage, folded wraps and the mixed-dtype DIA
    stencil on their solves. Builds ``dirac_gauged_matrix(32)`` with its
    folds, runs ``phase_storage_kernels``, then, with the launch counts set
    to 0: the operator stored in bf16 with ``[matrixlink]``'s 12 RHS,
    ``solve_sbcgrq`` at tol 1e-6 twice (bitwise repeat, converged, true
    relres <= 1e-5 against the stored operator's exact f64 lift; iterations
    and the relres against the f32 operator printed beside the f32 solve's),
    its public ``op(X)`` and one apply on a bf16 field (no launch, the
    repaired plain route's bits); the folded operator (iterations within 1
    of ``[matrixlink]``'s, true relres <= 1e-5) and its bf16 storage
    (converged); on the 128^3 Laplacian with the north-star B (k = 32): bf16
    diagonals with f32 fields at the north-star inner solve (tol 3e-6,
    qr_passes=1), iterations equal to the f32 operator's, and f32 diagonals
    with bf16 fields at tol 5e-3, iterations equal to the all-bf16 solve's
    (X bitwise equal where Y is: printed); and the bf16 operator with a bf16
    B of k = 96 at tol 5e-3 (the wide Gram), converged. Returns the launch
    counts of the solves."""
    from blockcg_tpu_torch import solve_sbcgrq
    from blockcg_tpu_torch.operators import BlockDIAOperator, astype
    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.problems import dirac_gauged_matrix, laplacian_dia
    from blockcg_tpu_torch.problems.presets import _rhs

    bf = torch.bfloat16
    _fold_env(True)
    try:
        op, build_s = _timed(torch, lambda: dirac_gauged_matrix(ML_L, m=0.5, device=dev))
    finally:
        _fold_env(False)
    print(f"[storage] dirac_gauged_matrix({ML_L}) with folds: built in {build_s:.1f} s")
    phase_storage_kernels(torch, dev, records, op)
    plain = BlockDIAOperator(op.blocks, op.offsets, op.wrap_zero, op.nnz)  # no folds
    op16 = astype(plain, bf)
    B = torch.as_tensor(np.random.default_rng(ML_SEED).standard_normal((ML_K, op.n)),
                        dtype=torch.float32, device=dev).T.contiguous()
    op64 = astype(plain, torch.float64)
    _native.reset_launches()

    def sbcgrq(o, rhs, tol, **kw):
        return _timed(torch, lambda: solve_sbcgrq(o, rhs, tol=tol, qr_passes=1, **kw))

    (X1, info), s1 = sbcgrq(op16, B, 1e-6)
    (X2, _), _ = sbcgrq(op16, B, 1e-6)
    (X32, info32), s32 = sbcgrq(plain, B, 1e-6)
    rel16 = true_relres(torch, op16, X1, B)
    rel32 = true_relres(torch, plain, X1, B, op64=op64)
    gb = [nbytes(o.blocks) / 1e9 for o in (plain, op16)]
    print(f"[storage] bf16 blocks SBCGrQ k={ML_K} tol=1e-6: {info.iterations} iterations "
          f"{s1:.3f} s (f32 blocks {info32.iterations} iterations {s32:.3f} s), repeat bitwise "
          f"{torch.equal(X1, X2)}, true relres {rel16:.3e} against the stored operator, "
          f"{rel32:.3e} against the f32 operator; blocks {gb[0]:.3f} GB f32, {gb[1]:.3f} GB "
          f"bf16")
    if not (bool(info.converged.all()) and torch.equal(X1, X2) and rel16 <= 1e-5):
        raise AssertionError(f"[storage] bf16 blocks: {info}, relres {rel16:.3e}")
    before = (_native.launches["block_stencil_spmm_t[bf16 coeffs]"],
              _native.functions["bcg_block_stencil_tma"])
    Y = op16(X1)  # the public apply on the flat f32 field: the (k, bs, ns) kernel
    view = (_native.launches["block_stencil_spmm_t[bf16 coeffs]"] - before[0],
            _native.functions["bcg_block_stencil_tma"] - before[1])
    print(f"[storage] op(X) on bf16 blocks: {view[0]} (k, bs, ns) launch, {view[1]} on TMA "
          "boxes (bcg_block_stencil_tma)")
    if not 0 < view[0] == view[1]:
        raise AssertionError(f"[storage] the view's apply: {view[1]} of {view[0]} launches on "
                             "TMA boxes")
    Xb = op16.to_internal(X1.T.contiguous()).to(bf)
    before = sum(_native.launches.values())
    Yb = op16.matmat_t(Xb)
    torch.cuda.synchronize()
    if sum(_native.launches.values()) != before or not torch.equal(Yb, op16._matmat_m_plain(Xb)):
        raise AssertionError("[storage] a bf16 field launched a kernel or left the plain route")
    print(f"[storage] bf16 field on the bf16 operator: the plain route, 0 launches, Y "
          f"{Yb.dtype}; op(X) {tuple(Y.shape)}")
    del X1, X2, X32, Y, Xb, Yb, op16

    _fold_env(True)
    before = (dict(_native.launches), _native.functions["bcg_block_stencil_tma"])
    try:
        (Xf, finfo), fs = sbcgrq(op, B, 1e-6)
        (Xf16, f16info), f16s = sbcgrq(astype(op, bf), B, 1e-6)
    finally:
        _fold_env(False)
    # Every folded launch of the two solves took the TMA boxes (bs_tma).
    folded = sum(c - before[0].get(w, 0) for w, c in _native.launches.items() if "[fold" in w)
    tma = _native.functions["bcg_block_stencil_tma"] - before[1]
    print(f"[storage] folded solves: {folded} folded launches, {tma} on TMA boxes "
          "(bcg_block_stencil_tma)")
    if not 0 < folded == tma:
        raise AssertionError(f"[storage] folded solves: {tma} of {folded} folded launches on "
                             "TMA boxes")
    frel = true_relres(torch, plain, Xf, B, op64=op64)
    print(f"[storage] folded SBCGrQ: {finfo.iterations} iterations {fs:.3f} s, true relres "
          f"{frel:.3e}; folded bf16 blocks {f16info.iterations} iterations {f16s:.3f} s")
    if not (bool(finfo.converged.all()) and abs(finfo.iterations - DIST_ML_ITERS) <= 1
            and frel <= 1e-5 and bool(f16info.converged.all())):
        raise AssertionError(f"[storage] folded: {finfo}, relres {frel:.3e}; bf16 {f16info}")
    del op, plain, op64, B, Xf, Xf16
    torch.cuda.empty_cache()

    lap = laplacian_dia(SHAPES[0], device=dev)
    lap16 = astype(lap, bf)
    B = _rhs(lap.n, K, torch.float32, device=dev)
    before = (_native.launches["stencil_spmm_t[bf16 coeffs]"],
              _native.functions["bcg_stencil_ring_bf16d"])
    (Xm, minfo), ms_ = sbcgrq(lap16, B, 3e-6)
    ring = (_native.launches["stencil_spmm_t[bf16 coeffs]"] - before[0],
            _native.functions["bcg_stencil_ring_bf16d"] - before[1])
    (Xu, uinfo), us = sbcgrq(lap, B, 3e-6)
    print(f"[storage] bf16 diagonals, f32 fields, {SHAPES[0][0]}^3 k={K} tol=3e-6: "
          f"{minfo.iterations} iterations {ms_:.3f} s; f32 operator {uinfo.iterations} "
          f"iterations {us:.3f} s; "
          f"X bitwise {torch.equal(Xm, Xu)}; {ring[0]} applies without the Gram, {ring[1]} on "
          "the ring (bcg_stencil_ring_bf16d)")
    if not (bool(minfo.converged.all()) and minfo.iterations == uinfo.iterations):
        raise AssertionError(f"[storage] bf16 diagonals: {minfo} against {uinfo}")
    if not 0 < ring[0] == ring[1]:
        raise AssertionError(f"[storage] bf16 diagonals: {ring[1]} of {ring[0]} applies "
                             "without the Gram on the ring")
    B16 = B.to(bf)
    (Xx, xinfo), xs = sbcgrq(lap, B16, 5e-3)
    (Xb, binfo), bs_ = sbcgrq(lap16, B16, 5e-3)
    print(f"[storage] f32 diagonals, bf16 fields, tol=5e-3: {xinfo.iterations} iterations "
          f"{xs:.3f} s; all bf16 {binfo.iterations} iterations {bs_:.3f} s; X bitwise "
          f"{torch.equal(Xx, Xb)}")
    if not (bool(xinfo.converged.all()) and xinfo.iterations == binfo.iterations):
        raise AssertionError(f"[storage] bf16 fields: {xinfo} against {binfo}")
    W = _rhs(lap.n, STORAGE_WIDE_K, bf, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (Xw, winfo), ws = sbcgrq(lap16, W, 5e-3)
    wpeak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[storage] bf16 {SHAPES[0][0]}^3 k={STORAGE_WIDE_K} tol=5e-3 (the wide bf16 Gram): "
          f"{winfo.iterations} iterations {ws:.3f} s, converged {bool(winfo.converged.all())}, "
          f"peak allocated {wpeak:.3f} GiB (operator, B and the solve)")
    if not bool(winfo.converged.all()):
        raise AssertionError(f"[storage] k = {STORAGE_WIDE_K}: {winfo}")
    counts = dict(_native.launches)
    del lap, lap16, B, B16, W, Xm, Xu, Xx, Xb, Xw
    torch.cuda.empty_cache()
    return counts


def _halo_case(torch, kern_fn, plain_fn, Y0):
    """(kern, plain, timed) for an in-place halo slab add: each compared
    call starts from a fresh copy of Y0, the timed ones add in place."""
    Yk, Yp = Y0.clone(), Y0.clone()

    def kern_t():
        out = kern_fn(Yk)
        return out if isinstance(out, tuple) else (out, None)

    def plain_t():
        out = plain_fn(Yp)
        return out if isinstance(out, tuple) else (out, None)

    def kern():
        Yk.copy_(Y0)
        return kern_t()

    def plain():
        Yp.copy_(Y0)
        return plain_t()
    return kern, plain, (kern_t, plain_t)


def phase_dist_kernels(torch, dev, records) -> None:
    """Rows 20 and 21 against their plain versions at the [dist] path's
    shapes. Row 20 on config 4's +t crossing at one rank: the (48, 32^3)
    halo into the last 8 slabs of g = 4096 sites of the (48, 32^4) field,
    without and with the Gram, with the Z2-gauged operator's edge links as
    ``vals``, and at m = 96. Row 21 on a ``dirac_eo(32)`` parity hop's
    crossing at (1, 4, 2^19) and on config 4's at (12, 4, 32^4)."""
    from blockcg_tpu_torch import parallel as par
    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.ops import const_block_stencil as cbs
    from blockcg_tpu_torch.problems import dirac_cbdia, dirac_eo, dirac_gauged_cbdia

    gen = torch.Generator(device=dev).manual_seed(7)

    def crossing(plan, ns):
        """The +t crossing of a one-rank plan: (hop, g, nblocks, dst_base,
        halo width, its index)."""
        i, (d, o, g, nb) = next((i, c) for i, c in enumerate(plan.crossings) if c[1] > 0)
        return torch.tensor(plan.hops[d], device=dev), g, nb, (ns - o) // g, o, i

    def is_gram(w):
        return w.dim() == 2 and w.shape[0] == w.shape[1]

    ns = DIRAC_L ** 4
    plan = par.partition_cbdia(dirac_cbdia(DIRAC_L, device=dev), 1)
    gplan = par.partition_cbdia(dirac_gauged_cbdia(DIRAC_L, device=dev), 1)
    hop, g, nb, dst, bw, _ = crossing(plan, ns)
    ghop, _, _, _, _, gi = crossing(gplan, ns)
    vals = torch.from_numpy(gplan.cross_vals[gi]).to(dev)
    print(f"[kernel] one-rank dirac_cbdia({DIRAC_L}) plan: crossings {plan.crossings}, "
          f"halo width {plan.bw}, slab width {plan.g}; the Z2 plan's edge values "
          f"{tuple(vals.shape)} in {{{', '.join(map(str, sorted(vals.unique().tolist())))}}}")
    cols = nb * g
    for m, gram, gauged in ((4 * DIRAC_K, False, False), (4 * DIRAC_K, True, False),
                            (4 * DIRAC_K, False, True), (4 * DIRAC_K, True, True),
                            (WIDE_M, False, False), (WIDE_M, True, False)):
        Src = torch.randn((m, bw), generator=gen, device=dev)
        Y0 = torch.randn((m, ns), generator=gen, device=dev)
        X = torch.randn((m, ns), generator=gen, device=dev)
        h, v = (ghop, vals) if gauged else (hop, None)
        args = (h, g, nb, dst, 0, Src)
        kern, plain, timed = _halo_case(
            torch, lambda Y: cbs.slab_m_accumulate_from(*args, Y, X, v, with_gram=gram),
            lambda Y: cbs.slab_from_plain(*args, Y, X, v, gram), Y0)
        library = None
        if m == 4 * DIRAC_K and not gram and not gauged:
            library, why = _halo_library(torch, h, g, nb, dst, 0, Src, Y0,
                                         cbs.slab_m_accumulate_from(*args, Y0.clone()))
            _library_note(f"slab_m_accumulate_from m={m} (addmm_ on the halo slab)", why)
        fbc = m * 4  # bytes of one site column
        work = (3 * fbc * cols + (0 if v is None else 4 * cols) + gram * (fbc * cols + m * m * 4),
                2 * (m // 4) * nnz(h) * cols + (0 if v is None else m * cols)
                + gram * 2 * m * m * cols)
        what = (f"halo ({m}, {bw}) into ({m}, {ns}) g={g} x {nb}"
                + (" with Gram" if gram else "") + (" Z2 vals" if gauged else ""))
        _native.reset_launches()
        kern()
        if dict(_native.launches) != {"slab_m_accumulate_from": 1}:
            raise AssertionError(f"slab_m_accumulate_from ({what}): {dict(_native.launches)} "
                                 "launches for one slab add")
        _timed_check(torch, "slab_m_accumulate_from", what + f" {dict(_native.functions)}",
                     kern, plain, is_gram, records, timed, work=work, library=library)
    del plan, gplan, Src, Y0, X
    eo = dirac_eo(DIRAC_L, device=dev)
    eplan = par.partition_cbdia(eo.hop_oe, 1)
    ns2 = eo.ns // 2
    for label, (h, g, nb, dst, bw, _), k, nsites in (
            (f"dirac_eo({DIRAC_L}) hop", crossing(eplan, ns2), 1, ns2),
            ("config 4 hop", crossing(par.partition_cbdia(dirac_cbdia(DIRAC_L, device=dev), 1),
                                      ns), DIRAC_K, ns)):
        Src = torch.randn((k, 4, bw), generator=gen, device=dev)
        Y0 = torch.randn((k, 4, nsites), generator=gen, device=dev)
        args = (h, g, nb, dst, 0, Src)
        kern, plain, timed = _halo_case(
            torch, lambda Y: cbs.slab_block_accumulate_from(*args, Y),
            lambda Y: cbs.slab_v_from_plain(*args, Y), Y0)
        cols = nb * g
        what = f"{label} halo ({k}, 4, {bw}) into ({k}, 4, {nsites}) g={g} x {nb}"
        library, why = _view_halo_library(torch, *args, Y0,
                                          cbs.slab_block_accumulate_from(*args, Y0.clone()))
        _library_note(f"slab_block_accumulate_from {what} (baddbmm_ on the halo columns)", why)
        _timed_check(torch, "slab_block_accumulate_from", what, kern, plain, is_gram, records,
                     timed, work=(3 * 16 * k * cols, 2 * k * nnz(h) * cols), library=library)
    del eo, eplan
    torch.cuda.empty_cache()


def _nccl_group(torch):
    """A process group of one rank on cuda:0 over NCCL, at a free local
    port. A failed init raises: the phase has no other backend."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    return dist.group.WORLD


def phase_dist(torch, dev) -> dict:
    """The distributed layer on one rank (NCCL, a group of one; at D = 1 the
    periodic t-hops still go round the halo ring): each solve beside its
    single-device run, with the Dist / single-device time ratio. The
    row-partitioned north star (``solve_refined_dist`` on 128^3, k = 32) to a
    true f64 relres <= 1e-10; config 4 through ``solve_sbcgrq_dist`` twice
    (bitwise identical, the reference's 13 iterations, X within
    ``BDIA_X_RTOL`` of the single-device solve); ``solve_dirac_eo_dist`` on
    ``dirac_eo(32)`` (7 iterations) and on its one-RHS column 0 (row 21);
    the matrix-link operator through ``partition_bdia`` (10 iterations);
    BCG, CG (column 0), the shifted block solve, Jacobi PSBCGrQ and
    Chebyshev SBCGrQ on config 3, each with its single-device iteration
    count (the f32 Grams differ in rounding: the fused apply's against the
    separate one). Returns the launch counts of the Dist solves."""
    import torch.distributed as dist

    from blockcg_tpu_torch import (
        jacobi_preconditioner,
        solve_bcg,
        solve_cg,
        solve_psbcgrq,
        solve_refined,
        solve_sbcgrq,
        solve_sbcgrq_cheb,
        solve_shifted_sbcgrq,
    )
    from blockcg_tpu_torch import parallel as par
    from blockcg_tpu_torch.operators.cheb import estimate_spectrum
    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.problems import (
        config3_sbcgrq_3d_64,
        config4_dirac_32,
        dirac_eo,
        dirac_gauged_matrix,
        laplacian_dia,
        solve_dirac_eo,
        solve_dirac_eo_dist,
    )
    from blockcg_tpu_torch.problems.presets import _rhs

    group = par.row_group() if dist.is_initialized() else _nccl_group(torch)
    counts: dict = {}

    def dist_run(fn):
        """Run a Dist solve with its launches added to ``counts``."""
        before = dict(_native.launches)
        out = _timed(torch, fn)
        for w, c in _native.launches.items():
            counts[w] = counts.get(w, 0) + c - before.get(w, 0)
        return out

    def line(label, di, dsec, si, ssec, extra=""):
        print(f"[dist] {label}: Dist {di.iterations} iterations {dsec:.3f} s, single-device "
              f"{si.iterations} iterations {ssec:.3f} s, Dist / single {dsec / ssec:.3f}{extra}")

    try:
        op = laplacian_dia(SHAPES[0], device=dev)
        B = _rhs(op.n, K, torch.float32, device=dev)
        dop = par.partition_dia(op, 1).shard(0, group, dev)
        (X, info), dsec = dist_run(lambda: par.solve_refined_dist(dop, B, group, tol=1e-10,
                                                                  inner_tol=3e-6))
        (_, sinfo), ssec = _timed(torch, lambda: solve_refined(op, B, tol=1e-10, inner_tol=3e-6,
                                                               qr_passes=1))
        rel = true_relres(torch, op, X, B)
        line("north star row-partitioned, solve_refined_dist 128^3 k=32 tol=1e-10 "
             "(cycles)", info, dsec, sinfo, ssec, f", true relres {rel:.3e}")
        if not (bool(info.converged.all()) and rel <= 1e-10):
            raise AssertionError(f"[dist] north star reached true relres {rel:.3e}: {info}")
        del op, B, dop, X
        torch.cuda.empty_cache()

        op, B, _ = config4_dirac_32(L=DIRAC_L, device=dev)
        dop = par.partition_cbdia(op, 1).shard(0, group, dev)
        runs = [dist_run(lambda: par.solve_sbcgrq_dist(dop, B, group, tol=1e-6))
                for _ in range(2)]
        ((X1, info), first), ((X2, info2), dsec) = runs
        (Xs, sinfo), ssec = _timed(torch, lambda: solve_sbcgrq(op, B, tol=1e-6, qr_passes=1))
        rel, dx = true_relres(torch, op, X1, B), relfro(X1, Xs)
        line(f"config 4 solve_sbcgrq_dist (crossings {dop.crossings}), the repeat", info2, dsec,
             sinfo, ssec, f", first run {first:.3f} s, repeat bitwise {torch.equal(X1, X2)}, "
             f"true relres {rel:.3e}, |X - X_single| / |X_single| {dx:.3e}")
        if not (info.iterations == DIRAC_REF_ITERS and torch.equal(X1, X2) and rel <= 1e-5
                and dx <= BDIA_X_RTOL):
            raise AssertionError(f"[dist] config 4: {info}, relres {rel:.3e}, dx {dx:.3e}")
        del dop, X1, X2, Xs, runs

        eo = dirac_eo(DIRAC_L, device=dev)
        # The first call builds and caches the context's one-rank plan.
        (_, _), first = dist_run(lambda: solve_dirac_eo_dist(eo, B, group, tol=1e-6))
        (X, info), dsec = dist_run(lambda: solve_dirac_eo_dist(eo, B, group, tol=1e-6))
        (Xs, sinfo), ssec = _timed(torch, lambda: solve_dirac_eo(eo, B, tol=1e-6))
        rel, dx = eo_true_relres(torch, eo, X, B), relfro(X, Xs)
        line(f"solve_dirac_eo_dist dirac_eo({DIRAC_L}) k={DIRAC_K}, the repeat", info, dsec,
             sinfo, ssec, f", first run (plan built) {first:.3f} s, true relres {rel:.3e}, "
             f"|X - X_single| / |X_single| {dx:.3e}")
        if not (info.iterations == DIST_EO_ITERS and rel <= 1e-5 and dx <= EO_X_RTOL):
            raise AssertionError(f"[dist] even-odd: {info}, relres {rel:.3e}, dx {dx:.3e}")
        (x, info), dsec = dist_run(lambda: solve_dirac_eo_dist(eo, B[:, :1], group, tol=1e-6))
        (_, sinfo), ssec = _timed(torch, lambda: solve_dirac_eo(eo, B[:, :1], tol=1e-6))
        rel = eo_true_relres(torch, eo, x, B[:, :1])
        line("solve_dirac_eo_dist one RHS (column 0)", info, dsec, sinfo, ssec,
             f", true relres {rel:.3e}")
        if not (bool(info.converged.all()) and rel <= 1e-5):
            raise AssertionError(f"[dist] even-odd one RHS: {info}, relres {rel:.3e}")
        del eo, op, B, X, Xs, x
        torch.cuda.empty_cache()

        op, build_s = _timed(torch, lambda: dirac_gauged_matrix(ML_L, m=0.5, device=dev))
        B = torch.as_tensor(np.random.default_rng(ML_SEED).standard_normal((ML_K, op.n)),
                            dtype=torch.float32, device=dev).T.contiguous()
        dop, part_s = _timed(torch, lambda: par.partition_bdia(op, 1).shard(0, group, dev))
        (X, info), dsec = dist_run(lambda: par.solve_sbcgrq_dist(dop, B, group, tol=1e-6))
        (_, sinfo), ssec = _timed(torch, lambda: solve_sbcgrq(op, B, tol=1e-6, qr_passes=1))
        rel = true_relres(torch, op, X, B)
        line(f"matrix link solve_sbcgrq_dist (built {build_s:.1f} s, partitioned "
             f"{part_s:.1f} s)", info, dsec, sinfo, ssec, f", true relres {rel:.3e}")
        if not (info.iterations == DIST_ML_ITERS and rel <= 1e-5):
            raise AssertionError(f"[dist] matrix link: {info}, relres {rel:.3e}")
        del op, B, dop, X
        torch.cuda.empty_cache()

        op, B, _ = config3_sbcgrq_3d_64(device=dev)
        dop = par.partition_dia(op, 1).shard(0, group, dev)
        M = jacobi_preconditioner(op)
        spectrum = tuple(float(v) for v in estimate_spectrum(op))
        b = B[:, 0].contiguous()
        for label, dist_fn, single_fn, relres_fn in (
                ("config 3 solve_bcg_dist",
                 lambda: par.solve_bcg_dist(dop, B, group, tol=1e-6),
                 lambda: solve_bcg(op, B, tol=1e-6), None),
                ("config 3 solve_cg_dist (column 0)",
                 lambda: par.solve_cg_dist(dop, b, group, tol=1e-6),
                 lambda: solve_cg(op, b, tol=1e-6),
                 lambda x: true_relres(torch, op, x[:, None], b[:, None])),
                (f"config 3 solve_shifted_sbcgrq_dist shifts {SHIFTS}",
                 lambda: par.solve_shifted_sbcgrq_dist(dop, B, SHIFTS, group, tol=1e-6),
                 lambda: solve_shifted_sbcgrq(op, B, SHIFTS, tol=1e-6),
                 lambda Xs: max(true_relres(torch, op, Xs[j], B, sg)
                                for j, sg in enumerate(SHIFTS))),
                ("config 3 solve_psbcgrq_dist (Jacobi)",
                 lambda: par.solve_psbcgrq_dist(dop, B, M, group, tol=1e-6),
                 lambda: solve_psbcgrq(op, B, M, tol=1e-6),
                 lambda X: true_relres(torch, op, X, B)),
                (f"config 3 solve_sbcgrq_cheb_dist degree {DIST_CHEB_DEGREE}",
                 lambda: par.solve_sbcgrq_cheb_dist(dop, B, group, spectrum=spectrum,
                                                    degree=DIST_CHEB_DEGREE, tol=1e-6),
                 lambda: solve_sbcgrq_cheb(op, B, spectrum=spectrum, degree=DIST_CHEB_DEGREE,
                                           tol=1e-6, qr_passes=1),
                 lambda X: true_relres(torch, op, X, B))):
            (X, info), dsec = dist_run(dist_fn)
            (_, sinfo), ssec = _timed(torch, single_fn)
            rel = None if relres_fn is None else relres_fn(X)
            line(label, info, dsec, sinfo, ssec,
                 "" if rel is None else f", true relres {rel:.3e}")
            # The BCG family holds its monitor; the others their true residual.
            if not (bool(info.converged.all()) and (rel is None or rel <= CG1_TRUE_RELRES)
                    and abs(info.iterations - sinfo.iterations) <= 2):
                raise AssertionError(f"[dist] {label}: {info} against {sinfo}, relres {rel}")
        del op, B, dop, M, X
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return counts


def main() -> None:
    root = Path(__file__).resolve().parent
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)")
    if not (root / "blockcg_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke.py: no blockcg_tpu_torch/ beside {__file__}; "
                         "run it from a checkout of the repository")
    sys.path.insert(0, str(root))
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase_device(torch)
    phase_build()
    records = phase_kernels(torch, dev)
    phase_cbs_kernels(torch, dev, records)
    phase_krylov_kernels(torch, dev, records)
    phase_cheb_kernel(torch, dev, records)
    phase_view_kernels(torch, dev, records)

    from blockcg_tpu_torch.ops import _native

    _native.reset_launches()
    phase_config3(torch, dev)  # checks its own six wrappers' counts
    # Each kernel's record counts its own path alone: the north-star chain
    # (its qr_passes=2 solve launches mm_update_gram), then config 4.
    _native.reset_launches()
    phase_north_star(torch, dev)
    counts = dict(_native.launches)
    print(f"[launches] north star: {counts}")
    missing = [w for w in NORTH_STAR_KERNELS if counts.get(w, 0) == 0]
    if missing:
        raise AssertionError(f"the north star never launched the kernels of {missing}")
    # Config 4's path: its const-hop kernels keep config 4's counts.
    _native.reset_launches()
    phase_config4(torch, dev)
    counts4 = dict(_native.launches)
    print(f"[launches] config 4: {counts4}")
    missing = [w for w in CONFIG4_WRAPPERS if counts4.get(w, 0) == 0]
    if missing:
        raise AssertionError(f"config 4 never launched the kernels of {missing}")
    counts.update({w: counts4[w] for w in CBS_KERNELS})
    # Configs 1 and 2 (BCG's xr_update_gram), then the multi-shift solves
    # on config 4 (qr_p_update).
    for label, phase, wrappers, own in (
            ("configs 1 and 2", phase_config12, CONFIG12_WRAPPERS, "xr_update_gram"),
            ("multi-shift", phase_config4_shifted, SHIFTED_WRAPPERS, "qr_p_update")):
        _native.reset_launches()
        phase(torch, dev)
        got = dict(_native.launches)
        print(f"[launches] {label}: {got}")
        missing = [w for w in wrappers if got.get(w, 0) == 0]
        if missing:
            raise AssertionError(f"{label} never launched the kernels of {missing}")
        counts[own] = got[own]
    # The matrix-link path: the block-stencil kernels keep its counts.
    got = phase_matrixlink(torch, dev, records)
    print(f"[launches] matrix link: {got}")
    missing = [w for w in MATRIXLINK_WRAPPERS if got.get(w, 0) == 0]
    if missing:
        raise AssertionError(f"the matrix-link solves never launched the kernels of {missing}")
    counts.update({w: got[w] for w in BS_KERNELS})
    torch.cuda.empty_cache()
    phase_bdia_config4(torch, dev)
    phase_complex(torch, dev, records)
    # The preconditioned paths, each with the counts set to 0 just before it:
    # Jacobi (an elementwise product, no kernel of its own), Chebyshev
    # (cheb_step keeps its counts), then the even-odd path, whose CG keeps
    # the counts of the (k, bs, ns) kernels. Their Gram variant has no
    # solver caller (in the reference neither): the CG's count of it is read
    # all the same, and is not required to be nonzero.
    for label, phase, wrappers in (
            ("precond", phase_precond, ("stencil_spmm_gram_t", "gram", "mm_update",
                                        "mm_update_gram")),
            ("cheb", phase_cheb, ("cheb_step", "stencil_spmm_t", "gram", "px_update")),
            ("even-odd CG", phase_eo, VIEW_KERNELS)):
        _native.reset_launches()
        got = phase(torch, dev)
        print(f"[launches] {label}: {got}")
        missing = [w for w in wrappers if got.get(w, 0) == 0]
        if missing:
            raise AssertionError(f"the {label} path never launched the kernels of {missing}")
        counts.update({w: got[w] for w in wrappers if w in ("cheb_step", *VIEW_KERNELS)})
    counts["const_block_stencil_spmm_gram_t"] = got.get("const_block_stencil_spmm_gram_t", 0)
    # Fields of m = 96 rows through the row-chunked launches: the kernels
    # (after every path has set its kernels' records), then the solves.
    phase_wide_kernels(torch, dev, records)
    phase_qr_px(torch, dev, records)
    _native.reset_launches()
    got = phase_wide_solves(torch, dev)
    print(f"[launches] m = {WIDE_M}: {got}")
    missing = [w for w in WIDE_WRAPPERS if got.get(w, 0) == 0]
    if missing:
        raise AssertionError(f"the m = {WIDE_M} solves never launched the kernels of {missing}")
    # General sparsity: tiled_spmm_t keeps its counts; qr_px_update has no
    # solver caller (in the reference neither), and its count is read here.
    _native.reset_launches()
    got = phase_sparse(torch, dev, records)
    print(f"[launches] sparse: {got}")
    missing = [w for w in SPARSE_WRAPPERS if got.get(w, 0) == 0]
    if missing:
        raise AssertionError(f"the sparse solves never launched the kernels of {missing}")
    counts["tiled_spmm_t"] = got["tiled_spmm_t"]
    counts["qr_px_update"] = got.get("qr_px_update", 0)
    phase_scattered(torch, dev)
    phase_bell(torch, dev)
    # Config 5 at full size: the bf16 variants' records and counts are those
    # of the capacity route (the lean solve), beside the f32 route.
    t5 = time.perf_counter()
    torch.cuda.empty_cache()
    phase_config5_kernels(torch, dev, records)
    torch.cuda.empty_cache()
    got, lean_peak, op5 = phase_config5_lean(torch, dev)
    print(f"[launches] config 5 lean: {got}")
    # Row 7 keeps the lean path's count (0 where the adaptive pass never
    # fired); its own path is the qr_passes=2 solve, printed beside it.
    row7 = phase_config5_qr2(torch, dev, op5)
    print(f"[launches] mm_update_gram[bf16]: {got.get('mm_update_gram[bf16]', 0)} on the "
          f"[config5] lean path, {row7} on [config5] qr2")
    missing = [w for w in CONFIG5_BF16 if w != "mm_update_gram[bf16]" and got.get(w, 0) == 0]
    missing += [] if row7 else ["mm_update_gram[bf16] (qr2)"]
    if missing:
        raise AssertionError(f"[config5] never launched the kernels of {missing}")
    counts.update({w: got.get(w, 0) for w in CONFIG5_BF16})
    del op5
    torch.cuda.empty_cache()
    phase_config5_f32(torch, dev, lean_peak)
    torch.cuda.empty_cache()
    print(f"[wall] config 5 {time.perf_counter() - t5:.1f} s")
    # The bf16 presets of configs 1-4: xr_update_gram[bf16] keeps config 2's
    # count; qr_p_update[bf16] and qr_px_update[bf16] have no bf16 solver path.
    t_presets = time.perf_counter()
    phase_bf16presets_kernels(torch, dev, records)
    got = phase_bf16presets(torch, dev)
    counts["xr_update_gram[bf16]"] = got["xr_update_gram[bf16]"]
    counts["qr_p_update[bf16]"] = counts["qr_px_update[bf16]"] = 0
    print(f"[wall] [bf16presets] {time.perf_counter() - t_presets:.1f} s")
    # [storage]: bf16 block storage, folded wraps, the mixed DIA stencil and
    # the wide bf16 Gram keep the counts of its solves.
    t_storage = time.perf_counter()
    got = phase_storage(torch, dev, records)
    print(f"[launches] storage: {got}")
    require_launches("[storage]", got, STORAGE_KERNELS)
    counts.update({w: got[w] for w in STORAGE_KERNELS})
    print(f"[wall] [storage] {time.perf_counter() - t_storage:.1f} s")
    # The distributed layer on one rank: rows 20 and 21 keep its counts.
    t_dist = time.perf_counter()
    phase_dist_kernels(torch, dev, records)
    _native.reset_launches()
    got = phase_dist(torch, dev)
    print(f"[launches] dist: {got}")
    missing = [w for w in DIST_KERNELS if got.get(w, 0) == 0]
    if missing:
        raise AssertionError(f"the [dist] solves never launched the kernels of {missing}")
    counts.update({w: got[w] for w in DIST_KERNELS})
    print(f"[wall] the distributed layer {time.perf_counter() - t_dist:.1f} s, "
          f"chip_smoke.py {time.perf_counter() - t_start:.1f} s")

    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[name], **records[name]}
               for name, (src, rep) in {**KERNELS, **BF16_KERNELS, **STORAGE_KERNELS}.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
