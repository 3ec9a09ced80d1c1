#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and no network; takes no arguments.  It

1. builds every hand-written kernel from ``dolfin_navier_scipy_tpu_torch/
   csrc/`` (one ``nvcc`` per source, started together),
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the driven paths give it (and ``vecmat`` at a ragged shape, f32
   and f64, every operand in the padded storage the kernel streams), counts
   the device kernels of one call captured in a CUDA graph (one per
   wrapper), and times
   kernel (CUDA-graph replay and eager), plain version, the one-call
   library equivalent where there is one, and the card's bound,
3. drives the main path through the user's entry points: the DFG 2D-2
   cylinder wake at level 1 (Re=100), Stokes start, 300 CNAB steps with the
   dense saddle-inverse solver via ``solve_nse`` — counting kernel launches
   from zero just before to just after,
4. repeats that run on the card (warm, for the loop's rate; it must give
   the same bits) and on the CPU in f64, and requires the card's final
   velocity within 1e-6 relative of the CPU's,
5. drives the rest of the DFG benchmark run on the same problem: 300
   ``sbdf2`` steps, the same horizon as two halves joined by
   ``resume_carry`` (same bits required), and the CNAB run with the in-loop
   lift/drag/pressure-drop series — each against its CPU f64 twin,
6. drives the user's default call, ``solve_nse(prob, t0, tE, Nts,
   start_ssstokes=True)`` with no ``linsolver``: at 8016 condensed rows the
   banded block-Schur solver with its truncated inverse W and bf16 level
   stacks, the w-space CNAB step — with ``warm_refine`` 0 and 1, a bitwise
   rerun, exact launch counts of the banded kernels, and the final velocity
   against the CPU f64 run of step 4; then ``sbdf2`` on the same solver
   against its CPU f64 run,
7. builds the block-Schur factors on the device (``setup="device"``: X by
   block PCG over the banded F) and from the host's splu on the level-1
   F: X and the solves of the two agree, two device builds give the same
   bits, and no hand-written kernel but B7 (the block PCG's tail) runs
   during a setup,
8. drives the default call at level 2 of the wake (29 507 condensed rows,
   where ``setup="auto"`` is the device setup): ``warm_refine`` 0 and 1, a
   bitwise rerun, exact launch counts, against the same run on the card's
   dense route (the ~29 507^2 inverse through ``vecmat``), and holds the
   kernels against their plain versions on the level-2 operands.

Step 2 also holds the three banded kernels of the Schur route
(``banded_mv``, ``rect_mv``, ``rect_mv_levels``) against their plain
versions on the level-1 solver's own operands under seeded vectors, and
the single-level products on edge operands (NaN padding, a ragged last
row block, windows past both ends of x, window starts at the edges, short
rows), each on the kernel its plan picks and on the bulk-copy ring: one
kernel node a call in a captured graph, the same bits on a replay; and
``rect_mv_levels`` on every level stack of the route (W, W's level 0
alone, X, ``S^-1`` in bf16 and in f32) forced onto each kernel form that
can take it (warp-per-row, row shares, ring), at level 1 and at level 2.
The default calls must launch each stack on the form its plan picks
(``rect_mv_levels.kernel_launches``, ``stack_launches``).

Step 2 also holds the affine element kernel (``csrc/affine.cu``) in every
mode of ``affine_mv`` and in its fused saddle residual ``affine_residual``
against the plain versions at levels 1 and 2 (f32 and f64 tables, inner
and full dof sets; at level 1 each form forced): one kernel node a call,
not a cooperative launch, the same bits on a rerun and a graph replay,
and times beside an empty kernel on the same grid.  The dense inner-layout
runs (``sbdf2`` at level 1, the dense route at level 2) take the residual
of their refinement round in one launch.

The steady slice (right after the level-2 controls, before the main
path): ``elemmv_checks`` holds the element-matrix matvec (``csrc/
elemmv.cu``, ``elem_mv``) against its plain version on every operand it
takes (the matrix-free steady route's f32 F blocks, stiffness plus
linearized convection, at levels 1 and 2, ``ElementOp`` M and A and
``DivElementOp`` J and J^T in f32 and f64), each one kernel node a call,
the same bits twice and on a replay, timed beside its bound and a
cuSPARSE CSR matvec, and the bits of the earlier kernel (a thread an
output dof) on seeded operands (``ELEM_BITS``); ``steady_krylov_level2``
solves the DFG 2D-1 steady benchmark (Re 20) at level 2 through
``solve_steadystate_nse`` (``auto``: the matrix-free route) against the
card's dense f64 LU route, with ``elem_mv`` launches equal to the
solver's F-matvecs (one launch an F-matvec: the affine stiffness runs in
the f64 residuals alone) and one FGMRES cycle traced;
``steady_dense_path`` the same call at level 1 (``auto``: the dense
route) against the host-sparse route in f64, the published coefficients
and a bitwise rerun;
``pseudotime_path`` the pseudo-time march at level 1 against that Newton
solution; after the CPU reference run, ``krylov_cnab`` runs the main
path's CNAB call on the Krylov saddle solver against it.

The 3D slice (after the level-2 path): ``wake3d_small`` drives the
Schaefer-Turek 3D-2Z wake (``cylinderwake3d_problem``, Re 100) at nz=2,
100 CNAB steps of dt 1e-3 from the Stokes start, through the default call
(the banded route) and ``banded=False`` (the element-operator block-Schur
route: F blocks through ``elem_mv``, ``S^-1`` and X through ``vecmat``, the
Jacobi-PCG tail through B7, ``csrc/pcg.cu``), ``warm_refine`` 0 and 1,
against the CPU f64 run of the element route (1e-4 / 1e-6), and holds the
3D forms of B5, B9, B10 and B7 against their plain versions on its
operands; ``wake3d_path`` drives both routes at nz=8 (the full width,
device setups): the routes' refine-1 runs agree to 1e-6, a bitwise rerun,
exact launches, and the kernels timed beside their bounds.  Every jacobi
or block PCG on the card (the W-less banded solve, the device setups' X
and W) runs its tail through B7.

The banded convection tail (phase ``banded_conv_path``, after the
checkpoints): ``conv_tail``, the tail's vector in one launch, at levels 1
and 2 against its plain version, against B5's vector, and against the bits
of the three-launch tail it replaced (``TAIL_BITS``), timed beside B5 and
the library calls of its two 0/1 products; then the default call at level
1 with ``banded_conv=True``.  The adjoint's ``vecmat_t`` is held to its
first kernel's bits too (``VECMAT_T_BITS``).

Every phase prints one JSON line; any failed phase raises, so the exit
code is non-zero and the final line is missing.  The last line is
``{"ok": true, "device": {...}}``, the one before it the ``kernels`` table.
"""

import contextlib
import copy
import ctypes
import glob
import hashlib
import inspect
import itertools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch
from torch.profiler import ProfilerActivity, profile

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
             "False); this script only runs on the card")

from dolfin_navier_scipy_tpu_torch.control import (
    apply_robin_penalty, get_heunab_lti)
from dolfin_navier_scipy_tpu_torch.models import (
    LiftDragSurfForce, cylinderwake3d_problem, cylinderwake_problem,
    make_inscan_liftdrag, observation_operator, pressure_drop)
from dolfin_navier_scipy_tpu_torch.ops import kernels
from dolfin_navier_scipy_tpu_torch.ops.affine import AffineVectorOps
from dolfin_navier_scipy_tpu_torch.ops.banded_conv import (
    banded_wins, build_banded_conv_tail, gate_constants, index_pipeline_us,
    tail_us)
from dolfin_navier_scipy_tpu_torch.ops.elementop import build_element_ops
from dolfin_navier_scipy_tpu_torch.ops.kernels import (
    _affine_launch, _windows, affine_mv, affine_mv_ref, affine_residual,
    affine_residual_ref, as_band_operand, as_vecmat_operand,
    banded_mv, banded_mv_ref, conv_quad_ref, conv_tail, conv_tail_ref,
    conv_vector,
    conv_vector_amatvec, conv_vector_amatvec_ref, conv_vector_ref, conv_vjp,
    conv_vjp_ref, elem_mv, elem_mv_ref, block_pcg_init, block_pcg_init_ref,
    block_pcg_step, block_pcg_step_ref, pcg_init, pcg_init_ref, pcg_step,
    pcg_step_ref, rect_mv, rect_mv_levels, rect_mv_levels_ref, rect_mv_ref,
    tail_sum_ref, vecmat, vecmat_ref, vecmat_t, vecmat_t_grid, vecmat_t_ref)
from dolfin_navier_scipy_tpu_torch.solve import (
    DirichletControl, KrylovSaddleSolver, SchurSaddleSolver, make_diff_cnab,
    sbdf2, solve_nse, solve_nse_newton_ti, solve_sadpnt_host,
    solve_steadystate_nse, solve_steadystate_pseudotime, steady)
from dolfin_navier_scipy_tpu_torch.utils.io import Timer
from dolfin_navier_scipy_tpu_torch.solve.newton_ti import _make_bundle, _sweep
from dolfin_navier_scipy_tpu_torch.solve.steady import (
    SteadyKrylovKernel, _sk_elem32)
from dolfin_navier_scipy_tpu_torch.solve.sadpnt import _tridiag_bmm
from dolfin_navier_scipy_tpu_torch.solve.timeint import (
    _NITER_WARM as NITER_WARM, _build_ops)
from tools_torch.seeded_inputs import (
    digest, seeded, seeded_operand, tail_state, wspace_kernel)

# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate
# and the f32 / f64 rates outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12
WRAPPERS = (vecmat, conv_vector, conv_vector_amatvec, banded_mv, rect_mv,
            rect_mv_levels, affine_mv, affine_residual, elem_mv)
NONE_BANDED = dict(banded_mv=0, rect_mv=0, rect_mv_levels=0)
# the backward kernels (counted apart: the paths before the adjoint's never
# launch them, and their launch tables name the forward wrappers alone)
ADJ_WRAPPERS = (vecmat_t, conv_vjp)

SEED = 0
LEVEL, RE, CHARVEL = 1, 100.0, 0.2
LEVEL2 = 2
T0, TE, NTS, SAVE_EVERY = 0.0, 0.3, 300, 60
RAGGED = (2049, 1023)
DESIGN = "pr3"       # one launch per call: bulk-copy ring / quad-point lanes
# csrc/bandmv.cu: a warp per row with the x window in shared memory, a
# bulk-copy ring over a grid of one block an SM (single-level f32 operands
# and level stacks too short in rows for the warp-per-row grid to fill the
# card), or a warp per row over equal contiguous row shares of a grid sized
# from the SM count (level stacks: ops/kernels.py: stack_plan)
BAND_DESIGN = {"rows": "warp-per-row", "ring": "bulk-copy ring",
               "share": "row shares"}
BAND_WRAPPERS = (banded_mv, rect_mv, rect_mv_levels)
# the kernels line's rows of the level stacks: W keeps the wrapper's name;
# S^-1 stands for SchurSaddleSolver._sapply of the JAX package
STACK_ROWS = {"X, 2 bf16 levels": "_X", "S^-1, 3 bf16 levels": "_S_inv"}
SAPPLY = "dolfin_navier_scipy_tpu/solve/sadpnt.py:1763"
BAND_REPLACES = dict(
    banded_mv="dolfin_navier_scipy_tpu/solve/sadpnt.py:782",
    rect_mv="dolfin_navier_scipy_tpu/solve/sadpnt.py:1021",
    rect_mv_levels="dolfin_navier_scipy_tpu/solve/sadpnt.py:1075")


def say(**kw):
    print(json.dumps(kw), flush=True)


def require(cond, msg):
    """A failed check ends the run (also under ``python -O``)."""
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps):
    """Mean device time of ``fn`` in ms (CUDA events around ``reps`` calls
    after a warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, calls=20, replays=10):
    """Device time of one call of ``fn`` in ms: ``calls`` calls captured
    into one CUDA graph and replayed, so the host's cost of launching (which
    dwarfs a few-microsecond kernel in back-to-back eager calls) is not in
    the way."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # captured on the warm-up stream: the kernels' scratch is per stream
    # and is made at a stream's first call, never inside a capture
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, replays) / calls


def library_times(fn, reps=200, calls=20):
    """One library call's time as its kernel's is taken: a CUDA-graph
    replay (``library_ms``), and back-to-back eager calls
    (``library_eager_ms``: what a caller that does not capture pays)."""
    return dict(library_ms=graph_ms(fn, calls=calls),
                library_eager_ms=time_ms(fn, reps))


def device_kernels(fn):
    """Device kernels that one call of ``fn`` runs: the kernel nodes (type
    0) of the call captured in a CUDA graph (``captured``), with every
    node's type.  Copies and memsets are nodes of other types.  Counted from
    the graph rather than ``torch.profiler``: on an H100 host a profiler
    session late in this script at times recorded no device event at all,
    retries included.  Returns ``(kernel nodes, node types)``."""
    types, _ = captured(fn)
    return types.count(0), types


def zero_counts():
    for w in WRAPPERS + ADJ_WRAPPERS + PCG_WRAPPERS:
        w.launches = 0
    conv_tail.launches = 0
    affine_mv.mode_launches = dict.fromkeys(affine_mv.mode_launches, 0)
    for w in BAND_WRAPPERS:
        w.kernel_launches = dict.fromkeys(w.kernel_launches, 0)
    rect_mv_levels.stack_launches = {}


def counts():
    return {w.__name__: w.launches for w in WRAPPERS}


def vecmat_bound_ms(m, n, itemsize=4):
    """Least time for ``x (m,) @ KT (m, n)``: each input read once, the
    output written once, over the memory rate; 2mn operations over the f32
    rate.  Returns ``(ms, "bytes" | "operations")``."""
    t_bytes = itemsize * (m * n + m + n) / HBM_BYTES_PER_S
    t_ops = 2.0 * m * n / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_vecmat(x, KT, what, reps, counted=False):
    """Kernel vs plain version on the same inputs, then the timings;
    ``counted``: also count the device kernels of one call (must be 1)."""
    m, n = KT.shape
    y = vecmat(x, KT)
    torch.cuda.synchronize()
    ref = vecmat_ref(x, KT)
    # both sum m f32 products, in another order: each is off the exact sum
    # by about eps32 * ||x||_2 * rms|KT| (random-walk rounding), so 1e-5 *
    # ||x||_2 * max|KT| is ~100 such errors; rtol covers large entries
    atol = 1e-5 * float(torch.linalg.vector_norm(x)) * float(KT.abs().max())
    rtol = 1e-4
    err = (y - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp_min(atol)).max())
    if not bool((err <= atol + rtol * ref.abs()).all()):
        raise AssertionError(
            f"vecmat kernel disagrees with vecmat_ref at {what} {(m, n)}: "
            f"max abs err {max_abs:.3e} (atol {atol:.3e}, rtol {rtol})")
    if not torch.equal(y, vecmat(x, KT)):
        raise AssertionError("vecmat kernel is not reproducible run to run")
    if counted:
        ran, types = device_kernels(lambda: vecmat(x, KT))
        require(ran == 1, f"vecmat ran {ran} device kernels (graph node "
                f"types {types})")
    KTt = KT.T                      # what the one-call library form takes
    bound, by = vecmat_bound_ms(m, n, KT.element_size())
    out = dict(shape=[m, n], operand=what, dtype=str(KT.dtype),
               ld=KT.stride(0), max_abs_err=max_abs, max_rel_err=max_rel,
               atol=atol, rtol=rtol,
               device_kernels_per_call=ran if counted else None,
               ms=graph_ms(lambda: vecmat(x, KT)),
               eager_ms=time_ms(lambda: vecmat(x, KT), reps),
               plain_ms=time_ms(lambda: vecmat_ref(x, KT), reps),
               **library_times(lambda: torch.mv(KTt, x), reps),
               bound_ms=bound, bound_by=by)
    out["roofline_share"] = bound / out["ms"]
    return out


def conv_bound_ms(t, u_itemsize, fused, two, nfac):
    """Least time for one convection call on tables ``t``: every input (the
    state(s), the int32 dof table, ``JinvT``, ``wdet``, ``N2``, ``dN2``, the
    facet blocks and their dof table) read once and the output(s) written
    once over the memory rate; the multiply-adds of the element chain, the
    facet blocks and the reduction over the rate of the work type."""
    s = t.wdet.element_size()
    nc, nd, Q, dim, nvpc = t.nc, t.nd, t.Q, t.dim, t.nvpc
    nout = 2 if fused else 1
    nbytes = (u_itemsize * t.nv_full * ((2 if two else 1) + nout)
              + 4 * nc * nd + s * nc * (dim * dim + Q)
              + s * Q * nvpc * (1 + dim) + nfac * nd * (s * nd + 4))
    per_q = (2 * nvpc * dim            # u at the point
             + 2 * nvpc * dim * dim    # reference gradients
             + 2 * dim ** 3            # pull-back
             + 2 * dim * dim + dim     # (u . grad) u, weighted
             + 2 * nvpc * dim)         # into the element load
    if fused:
        per_q += (dim * dim + 2 * dim ** 3 + dim * dim + 1
                  + 2 * nvpc * dim * dim)
    flops = nc * Q * per_q + 2 * nfac * nd * nd + nout * nc * nd + nfac * nd
    rate = F32_FLOP_PER_S if s == 4 else F64_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_conv(kern, aff, facv, u, u2, what, sym_main, timed,
               counted=False):
    """The convection kernel against its plain version on the same inputs:
    ``conv_vector`` with one and two states, ``conv_vector_amatvec`` with
    ``sym`` both ways and the facet blocks; two launches must give the same
    bits.  Timings (``timed``) for the one-state vector and the fused form
    the main path calls."""
    t = kern.tables
    most = t.kernel_tables()[1].shape[0]      # the ELL table's width
    # the result is rounded to the state's type when that is narrower
    eps = max(torch.finfo(t.dtype).eps, torch.finfo(u.dtype).eps)
    nfac = int(aff.fac_elem.shape[0])

    def fused_form(sym):
        return (f"amatvec_sym_{sym}", True, False,
                lambda: conv_vector_amatvec(u, aff.nu, sym, t, aff.fac_elem,
                                            facv),
                lambda: conv_vector_amatvec_ref(u, aff.nu, sym, t,
                                                aff.fac_elem, facv))

    forms = [("vector", False, False,
              lambda: (conv_vector(u, None, t),),
              lambda: (conv_vector_ref(u, None, t),)),
             ("vector_two_states", False, True,
              lambda: (conv_vector(u, u2, t),),
              lambda: (conv_vector_ref(u, u2, t),)),
             fused_form(True), fused_form(False)]
    out = []
    for name, fused, two, run, plain in forms:
        got, ref, again = run(), plain(), run()
        torch.cuda.synchronize()
        errs, atols = [], []
        for g, r, a in zip(got, ref, again):
            # both sum the same products in another order: 50 eps of the
            # largest entry for each of the (at most `most`) slots of a dof
            atol = 50 * eps * float(r.abs().max()) * most
            err = float((g - r).abs().max())
            require(g.dtype == u.dtype and g.shape == r.shape, "output type")
            require(err <= atol, f"convection kernel ({name}, {what}) "
                    f"disagrees with its plain version: max abs err "
                    f"{err:.3e} > {atol:.3e}")
            require(torch.equal(g, a), f"convection kernel ({name}, {what}) "
                    "is not reproducible launch to launch")
            errs.append(err)
            atols.append(atol)
        bound, by = conv_bound_ms(t, u.element_size(), fused, two,
                                  nfac if fused else 0)
        row = dict(form=name, operand=what, tables=str(t.dtype),
                   state=str(u.dtype), nc=t.nc, nv_full=t.nv_full,
                   facet_blocks=nfac if fused else 0, max_slots_per_dof=most,
                   max_abs_err=max(errs), atol=max(atols), bound_ms=bound,
                   bound_by=by, library_ms=None)
        if timed and name in ("vector", f"amatvec_sym_{sym_main}"):
            if counted:
                ran, types = device_kernels(run)
                require(ran == 1, f"convection kernel ({name}, {what}) ran "
                        f"{ran} device kernels (graph node types {types})")
                row["device_kernels_per_call"] = ran
            row.update(ms=graph_ms(run), plain_ms=graph_ms(plain),
                       eager_ms=time_ms(run, 200),
                       plain_eager_ms=time_ms(plain, 50))
        out.append(row)
    return out


def band_bound_ms(item, nblk, levels, bs, w, nx, nrows, bases, x_item=4):
    """Least time for one banded product: the stored levels (``item``
    bytes an entry), ``x`` (``x_item`` bytes an entry) and the window
    starts read once, ``y`` written once, over the memory rate; one
    multiply-add an entry over the f32 rate."""
    entries = nblk * levels * bs * w
    nbytes = (item * entries + x_item * nx + 4 * nrows
              + (4 * nblk if bases else 0))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2.0 * entries / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def band_forms(slv, gen):
    """Every banded product the Schur route makes, on the solver's own
    blocks under a seeded vector of the size the route feeds it: ``(name,
    operand label, blocks, call, plain, plain over |B| and |x|, library,
    bound args)``; the four callables take the blocks, so that the timing
    can cycle over copies of them."""
    dev = slv.Bblk.device
    nin, npp = slv._nin, slv.np

    def vec(n):
        return torch.randn(n, generator=gen, dtype=torch.float32).to(dev)

    def lib(B, base, x, lev=None):
        # one torch.bmm over the windows gathered beforehand (x cast to the
        # blocks' type; the levels' row sum is not in it)
        nblk, nl, bs, w = (B[:, None] if B.dim() == 3 else B[:, :lev]).shape
        xw = _windows(x, base, w).to(B.dtype)[:, :, None].contiguous()

        def call(C):
            C = C[:, None] if C.dim() == 3 else C[:, :lev]
            return torch.bmm(C.reshape(nblk, nl * bs, w), xw)
        return call

    forms = []

    def add(*form):
        forms.append(form)

    for operand, B in (("E band (explicit A)", slv.Eblk),
                       ("F band", slv.Bblk)):
        x = vec(nin)
        base = (torch.arange(B.shape[0], device=dev) - 1) * B.shape[1]
        add("banded_mv", operand, B,
            lambda B, x=x: banded_mv(B, x),
            lambda B, x=x: banded_mv_ref(B, x),
            lambda B, x=x: banded_mv_ref(B.abs(), x.abs()),
            lib(B, base, x),
            (B.element_size(), B.shape[0], 1, B.shape[1], B.shape[2], nin,
             nin, False))
    for operand, B, bases, nx, nrows in (
            ("J", slv.Jb, slv._jbases_t, nin, npp),
            ("J^T", slv.JTb, slv._jtbases_t, npp, nin)):
        x = vec(nx)
        add("rect_mv", operand, B,
            lambda B, b=bases, x=x, n=nrows: rect_mv(B, b, x, n),
            lambda B, b=bases, x=x, n=nrows: rect_mv_ref(B, b, x, n),
            lambda B, b=bases, x=x, n=nrows: rect_mv_ref(B.abs(), b,
                                                         x.abs(), n),
            lib(B, bases, x),
            (B.element_size(), B.shape[0], 1, B.shape[1], B.shape[2], nx,
             nrows, True))
    sinv32 = as_band_operand(slv.Sinv.float())
    for operand, S, bases, nx, nrows in (
            ("W, 3 bf16 levels", slv.Wb, slv._wbases_t, nin, nin),
            ("X, 2 bf16 levels", slv.Xb, slv._xbases_t, npp, nin),
            ("S^-1, 3 bf16 levels", slv.Sinv, slv._sbase, npp, npp),
            ("S^-1, 3 f32 levels", sinv32, slv._sbase, npp, npp)):
        x = vec(nx)
        # W's level 0 alone is the predictor of a refined solve
        for hi in ((False, True) if operand[0] == "W" else (False,)):
            lev = 1 if hi else S.shape[1]
            add("rect_mv_levels", operand + (", hi_only" if hi else ""), S,
                lambda S, b=bases, x=x, n=nrows, hi=hi:
                rect_mv_levels(S, b, x, n, hi),
                lambda S, b=bases, x=x, n=nrows, hi=hi:
                rect_mv_levels_ref(S, b, x, n, hi),
                lambda S, b=bases, x=x, n=nrows, hi=hi:
                rect_mv_levels_ref(S.abs(), b, x.abs(), n, hi),
                lib(S, bases, x, lev),
                (S.element_size(), S.shape[0], lev, S.shape[2], S.shape[3],
                 nx, nrows, True))
    return forms


def cold_copies(B, nbytes=160e6):
    """``B`` and enough copies of it (same storage layout) that cycling
    over them streams more than three times the card's 50 MB L2: in a step
    each operand is read once among ~150 MB of others, so a timing that
    re-reads one operand from L2 would not be the step's."""
    k = max(1, min(64, int(np.ceil(nbytes / (B.numel() * B.element_size())))))
    return [B] + [as_band_operand(B) for _ in range(k - 1)]


def cycling(fn, copies):
    it = itertools.cycle(copies)
    return lambda: fn(next(it))


def band_kernel(name, B, levels=None):
    """Which kernel of csrc/bandmv.cu a call of wrapper ``name`` on ``B``
    (a level stack: its first ``levels`` levels) launches: ``"ring"``,
    ``"rows"`` or ``"share"`` (ops/kernels.py: bandmv_plan, stack_plan)."""
    nblk, bs, w = B.shape[0], B.shape[-2], B.shape[-1]
    if name == "rect_mv_levels":
        return kernels._stack_plan_on(
            nblk, levels or B.shape[1], bs, w, B.stride(-2),
            B.element_size(), B.get_device(),
            kernels._STACK_PLAN["FORM"]).kernel
    return kernels._bandmv_plan_on(nblk, bs, w, B.stride(-2),
                                   B.get_device(), B.element_size()).kernel


@contextlib.contextmanager
def stack_form(form):
    """Every level stack on kernel form ``form`` (ops/kernels.py:
    stack_plan), whatever the plan would pick."""
    kernels._STACK_PLAN["FORM"] = form
    try:
        yield
    finally:
        kernels._STACK_PLAN["FORM"] = None


def stack_operands(slv):
    """The level stacks of the Schur route: ``(label, stack, bases, nx,
    nrows, hi_only)`` for W, W's level 0 alone, X, and S^-1 in bf16 and as
    an f32 stack."""
    nin, npp = slv._nin, slv.np
    return [("W, 3 bf16 levels", slv.Wb, slv._wbases_t, nin, nin, False),
            ("W, 3 bf16 levels, hi_only", slv.Wb, slv._wbases_t, nin, nin,
             True),
            ("X, 2 bf16 levels", slv.Xb, slv._xbases_t, npp, nin, False),
            ("S^-1, 3 bf16 levels", slv.Sinv, slv._sbase, npp, npp, False),
            ("S^-1, 3 f32 levels", as_band_operand(slv.Sinv.float()),
             slv._sbase, npp, npp, False)]


def check_stack_forms(slv, gen):
    """``rect_mv_levels`` on every level stack of the route, forced onto
    each kernel form that can take it: within the row bar, the same bits
    twice, one kernel node a call in a captured graph, the same bits from
    its replay; and the forms' results bitwise equal (their row sums do
    not depend on the schedule).  Returns the rows and ``{label: the form
    the plan picks}``."""
    out, picked = [], {}
    dev = slv.Bblk.device
    for label, S, bases, nx, nrows, hi in stack_operands(slv):
        x = torch.randn(nx, generator=gen, dtype=torch.float32).to(dev)
        lev = 1 if hi else S.shape[1]
        picked[label] = band_kernel("rect_mv_levels", S, lev)
        ref = rect_mv_levels_ref(S, bases, x, nrows, hi)
        tol = 1e-5 * rect_mv_levels_ref(S.abs(), bases, x.abs(), nrows,
                                        hi) + 1e-30
        first = None
        for form in ("rows", "share", "ring"):
            try:
                kernels.stack_plan(S.shape[0], lev, S.shape[2], S.shape[3],
                                   S.stride(2), S.element_size(),
                                   kernels._sm_count(dev), form)
            except ValueError:
                continue                  # this form cannot take the stack

            def call(S=S, x=x, hi=hi):
                return rect_mv_levels(S, bases, x, nrows, hi)
            with stack_form(form):
                y, again = call(), call()
                torch.cuda.synchronize()
                err = (y - ref).abs()
                what = f"rect_mv_levels ({label}, {form} kernel)"
                require(bool(torch.isfinite(y).all()), f"{what} not finite")
                require(bool((err <= tol).all()), f"{what} disagrees with "
                        f"its plain version: worst ratio to the row bar "
                        f"{float((err / tol).max()):.3e}")
                require(torch.equal(y, again), f"{what} is not reproducible")
                types, replayed = captured(call)
                require(types.count(0) == 1, f"{what}: graph nodes {types}")
                require(torch.equal(replayed, y), f"{what}: the graph replay "
                        "differs from the eager call")
            if first is None:
                first = y
            out.append(dict(operand=label, kernel=form,
                            picked=form == picked[label],
                            shape=[S.shape[0], lev, *S.shape[2:]],
                            max_abs_err=float(err.max()),
                            max_err_over_row_bar=float((err / tol).max()),
                            equal_to_first_form=bool(torch.equal(y, first)),
                            graph_kernel_nodes=types.count(0),
                            bitwise_twice=True, graph_replay_equal=True))
    return out, picked


def stack_counts_want(slv, picked, nsteps, refine):
    """The launches of ``rect_mv_levels`` a default call makes, by launched
    stack shape and by kernel form: a solve is W (level 0 alone where a
    refine round follows), S^-1, X; a refine round another W, S^-1, X."""
    W, X, S = (tuple(t.shape) for t in (slv.Wb, slv.Xb, slv.Sinv))
    by_shape = {W: nsteps, X: nsteps * (1 + refine),
                S: nsteps * (1 + refine)}
    forms = {"W, 3 bf16 levels": nsteps, "X, 2 bf16 levels": by_shape[X],
             "S^-1, 3 bf16 levels": by_shape[S]}
    if refine:
        by_shape[(W[0], 1, *W[2:])] = nsteps
        forms["W, 3 bf16 levels, hi_only"] = nsteps
    by_form = dict.fromkeys(rect_mv_levels.kernel_launches, 0)
    for label, n in forms.items():
        by_form[picked[label]] += n
    return by_shape, by_form


@contextlib.contextmanager
def ring_everywhere():
    """Every single-level f32 product on the ring kernel, whatever the plan
    would pick (its plans made anew on the way in and out)."""
    shipped = kernels._BANDMV_PLAN["RING_GRID_BELOW"]
    kernels._BANDMV_PLAN["RING_GRID_BELOW"] = 1 << 30
    kernels._bandmv_plan_on.cache_clear()
    try:
        yield
    finally:
        kernels._BANDMV_PLAN["RING_GRID_BELOW"] = shipped
        kernels._bandmv_plan_on.cache_clear()


def captured(fn, cooperative=None):
    """``fn`` captured once in a CUDA graph (on a side stream that ran it
    first) and replayed: ``(node types, the replay's output)``; the nodes
    read through libcuda (``cuGraphGetNodes``; type 0 a kernel), which
    counts a call's kernels where the profiler may see nothing.  A list
    ``cooperative`` gets each kernel node's cooperative-launch attribute
    (``cuGraphKernelNodeGetAttribute``; None where libcuda does not say)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    require(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0,
            "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    require(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0,
            "cuGraphGetNodes")
    types = []
    for i in range(n.value):
        kind = ctypes.c_int(-1)
        require(cu.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]),
                                      ctypes.byref(kind)) == 0,
                "cuGraphNodeGetType")
        types.append(kind.value)
        if cooperative is not None and kind.value == 0:
            val = (ctypes.c_int * 16)()       # CUlaunchAttributeValue
            ok = cu.cuGraphKernelNodeGetAttribute(
                ctypes.c_void_p(nodes[i]), 2,  # ..._ATTRIBUTE_COOPERATIVE
                ctypes.byref(val)) == 0
            cooperative.append(bool(val[0]) if ok else None)
    graph.replay()
    torch.cuda.synchronize()
    return types, out


def band_edge_forms(slv, gen):
    """Edge operands of the single-level f32 products, seeded, in
    band-operand storage with the padding columns filled with NaN: windows
    past both ends of x (banded), a ragged last row block, window starts
    before 0, at 0, at and past the end of x, rows of 253 columns (3 NaN
    columns a row), rows of 6 columns one to a block, and the solver's
    J^T (256 columns).  ``(name, operand, blocks, call, plain, plain over
    |B| and |x|)``."""
    dev = slv.Bblk.device

    def vec(n):
        return torch.randn(n, generator=gen, dtype=torch.float32).to(dev)

    def blocks(nblk, bs, w):
        B = as_band_operand(torch.randn((nblk, bs, w), generator=gen),
                            device=dev)
        B.as_strided((nblk, bs, B.stride(1)), B.stride())[..., w:] = \
            float("nan")
        return B

    def rect(operand, B, bases, nx, nrows):
        b = torch.as_tensor(np.asarray(bases, np.int32), device=dev)
        x = vec(nx)
        return ("rect_mv", operand, B,
                lambda: rect_mv(B, b, x, nrows),
                lambda: rect_mv_ref(B, b, x, nrows),
                lambda: rect_mv_ref(B.abs(), b, x.abs(), nrows))

    E = blocks(5, 96, 288)
    xe = vec(5 * 96 - 50)
    return [
        ("banded_mv", "windows past both ends", E,
         lambda: banded_mv(E, xe), lambda: banded_mv_ref(E, xe),
         lambda: banded_mv_ref(E.abs(), xe.abs())),
        rect("ragged last row block", blocks(7, 128, 300),
             [100 * k for k in range(7)], 1000, 7 * 128 - 77),
        rect("window starts at the edges", blocks(5, 64, 120),
             [-5, 0, 280, 397, 410], 400, 5 * 64),
        rect("NaN padding, 253 columns", blocks(19, 384, 253),
             list(range(0, 19 * 300, 300)), 7000, 19 * 384),
        rect("6 columns, one row a block", blocks(50, 1, 6), list(range(50)),
             60, 50),
        rect("J^T of the solver", slv.JTb, slv._jtbases, slv.np, slv._nin)]


def check_band_edges(forms):
    """Each edge form on the kernel the plan picks and on the ring kernel:
    within the row bar, the same bits twice, one kernel node a call, and
    the same bits from a CUDA-graph replay."""
    out = []
    for name, operand, B, call, plain, absplain in forms:
        for forced in (False, True):
            with (ring_everywhere() if forced else contextlib.nullcontext()):
                kernel = band_kernel(name, B)
                y, again = call(), call()
                torch.cuda.synchronize()
                ref = plain()
                err = (y - ref).abs()
                tol = 1e-5 * absplain() + 1e-30
                what = f"{name} ({operand}, {kernel} kernel)"
                require(bool(torch.isfinite(y).all()), f"{what} not finite")
                require(bool((err <= tol).all()), f"{what} disagrees with its "
                        f"plain version: worst ratio to the row bar "
                        f"{float((err / tol).max()):.3e}")
                require(torch.equal(y, again), f"{what} is not reproducible")
                types, replayed = captured(call)
                require(types.count(0) == 1, f"{what}: graph nodes {types}")
                require(torch.equal(replayed, y), f"{what}: the graph replay "
                        "differs from the eager call")
            out.append(dict(name=name, operand=operand, kernel=kernel,
                            shape=list(B.shape),
                            max_abs_err=float(err.max()),
                            max_err_over_row_bar=float((err / tol).max()),
                            graph_kernel_nodes=types.count(0),
                            bitwise_twice=True, graph_replay_equal=True))
    return out


def check_band(forms, counted=True):
    """Each banded kernel against its plain version: both sum at most a
    few thousand f32 products of one row in another order, each off the
    exact sum by a few eps32 times the row's sum of |B||x|; the bar is
    1e-5 of that sum (~80 eps32).  Two launches must give the same bits.
    Then the timings (cycling over copies of the blocks, L2 cold as in the
    step) and the bound."""
    out = []
    for name, operand, B, call, plain, absplain, library, bargs in forms:
        y, ref, again = call(B), plain(B), call(B)
        torch.cuda.synchronize()
        err = (y - ref).abs()
        # each row's sum of |B||x|, the scale of its rounding
        tol = 1e-5 * absplain(B) + 1e-30
        max_abs = float(err.max())
        require(y.dtype == torch.float32 and y.shape == ref.shape,
                f"{name} ({operand}): output type")
        require(bool(torch.isfinite(y).all()), f"{name} ({operand}) not "
                "finite")
        require(bool((err <= tol).all()),
                f"{name} kernel ({operand}) disagrees with its plain "
                f"version: max abs err {max_abs:.3e}, worst ratio to the "
                f"row bar {float((err / tol).max()):.3e}")
        require(torch.equal(y, again),
                f"{name} kernel ({operand}) is not reproducible")
        row = dict(name=name, operand=operand,
                   kernel=band_kernel(name, B, bargs[2]),
                   shape=list(bargs[1:5]), bytes_per_entry=bargs[0],
                   max_abs_err=max_abs,
                   max_err_over_row_bar=float((err / tol).max()),
                   max_abs_ref=float(ref.abs().max()))
        if counted:
            ran, types = device_kernels(lambda: call(B))
            require(ran == 1, f"{name} ({operand}) ran {ran} device kernels "
                    f"(graph node types {types})")
            row["device_kernels_per_call"] = ran
        copies = cold_copies(B)
        run = cycling(call, copies)
        bound, by = band_bound_ms(*bargs)
        # a library form is a callable (one torch.bmm over windows gathered
        # beforehand) or a (callable, what it calls) pair
        library, lib_label = (
            library if isinstance(library, tuple) else
            (library, "torch.bmm over windows gathered beforehand"))
        row.update(ms=graph_ms(run, calls=max(20, len(copies))),
                   eager_ms=time_ms(run, 200),
                   plain_ms=time_ms(cycling(plain, copies), 50),
                   **(dict(library_ms=None) if library is None else
                      library_times(cycling(library, copies),
                                    calls=max(20, len(copies)))),
                   library=None if library is None else lib_label,
                   timed_over_copies=len(copies),
                   ms_warm_l2=graph_ms(lambda: call(B)),
                   bound_ms=bound, bound_by=by)
        row["roofline_share"] = bound / row["ms"]
        del copies, run
        out.append(row)
    return out


def rel(a, b):
    a, b = a.cpu().double(), b.cpu().double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def divergence_rel(prob, v, g=None):
    """``max|J v - g| / max(|J||v|)`` of a natural-order inner velocity;
    ``g`` the continuity rhs (default ``fp``; a controlled run's last one
    carries the control dofs' ``-J_bc cvals``: its carry's ``gp``)."""
    vh = v.cpu().numpy()
    g = prob.fp.ravel() if g is None else g.cpu().numpy()
    return float(np.abs(prob.Jc @ vh - g).max()
                 / (abs(prob.Jc) @ np.abs(vh)).max())


def device_setup_path(prob, dev, dt):
    """The block-Schur factors built on the card (``setup="device"``: X by
    block PCG over the banded F, S from the stored X, ``S^-1`` from an f64
    inverse on the card) against the ones from the host's splu, on the
    level-1 ``F = M + dt/2 A``.  In f32 storage (no bf16 levels, no W: what
    is compared is X) X agrees to 1e-5 of its largest entry and the solves
    (refine 0 and 1) to 1e-5; two builds in the card's default storage
    (bf16 levels, W) give the same bits; no hand-written kernel but B7's
    column-blocked form (the block PCG's tail) runs in a setup."""
    F = sps.csr_matrix(prob.Mc + 0.5 * dt * prob.Ac)
    args = (F, prob.Jc, prob.JTc)
    zero_counts()
    built = {}
    for name, kw in (("host_f32", dict(setup="host", lowbit=False,
                                       winv=False)),
                     ("device_f32", dict(setup="device", lowbit=False,
                                         winv=False)),
                     ("device", dict(setup="device")),
                     ("device_again", dict(setup="device"))):
        t0 = time.time()
        built[name] = SchurSaddleSolver(*args, device=dev, **kw)
        torch.cuda.synchronize()
        built[name + "_seconds"] = time.time() - t0
    setup_counts = counts()
    require(setup_counts == {w.__name__: 0 for w in WRAPPERS},
            f"kernel launches during the setups: {setup_counts}")
    # the device setups' block PCG (X; W in the default storage) is B7's
    # column-blocked form, one launch an iteration after torch.bmm
    setup_b7 = pcg_counts()
    require(setup_b7["block_pcg_step"] > 0 and setup_b7["pcg_step"] == 0,
            f"B7 launches during the setups: {setup_b7}")
    host, devs = built["host_f32"], built["device_f32"]
    require(host.setup == "host" and devs.setup == "device", "setups")
    xscale = float(host.Xb.abs().max())
    x_err = float((devs.Xb - host.Xb).abs().max()) / xscale
    require(x_err <= 1e-5, f"device X vs host X: {x_err:.3e} of max|X|")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    bv = torch.randn(host.nv, generator=gen).to(dev)
    bp = torch.randn(host.np, generator=gen).to(dev)
    solve_err = {}
    for refine in (0, 1):
        host.refine = devs.refine = refine
        solve_err[refine] = rel(devs.solve(bv, bp), host.solve(bv, bp))
        require(solve_err[refine] <= 1e-5, f"device vs host setup, solve "
                f"with refine {refine}: {solve_err[refine]:.3e}")
    a, b = built["device"], built["device_again"]
    for name, levels in (("Wb", 3), ("Xb", 2), ("Sinv", 3)):
        st = getattr(a, name)
        require(st.dtype == torch.bfloat16 and st.shape[1] == levels,
                f"{name}: {levels} bf16 levels")
        require(torch.equal(st, getattr(b, name)),
                f"two device builds differ in {name}")
    say(phase="device_setup_path", problem="cylinderwake level 1, Re 100",
        F="M + dt/2 A, dt 1e-3", nv=host.nv, np=host.np,
        x_err_over_max_x=x_err, solve_rel_err=solve_err,
        builds_bitwise_equal=True, launches_during_setups=setup_counts,
        b7_launches_during_setups=setup_b7,
        seconds={k: v for k, v in built.items() if k.endswith("seconds")},
        parts_seconds={k: built[k].setup_timing
                       for k in ("host_f32", "device_f32", "device")})


def level2_path(dev, gen, nsteps):
    """The default call at level 2 (``setup="auto"`` is the device setup
    there): ``warm_refine`` 0 and 1, a bitwise rerun, exact launch counts,
    divergence, and the final velocity against the same run on the card's
    dense route (inner layout: the ~29 507^2 inverse through ``vecmat``,
    one apply and one refinement round a step); then every kernel against
    its plain version on that path's operands.  Returns the dense route's
    launches of the fused residual and the rows for the ``kernels``
    line."""
    t0 = time.time()
    prob = cylinderwake_problem(level=LEVEL2, Re=RE, charvel=CHARVEL)
    problem_s = time.time() - t0
    dkw = dict(t0=T0, tE=TE, Nts=NTS, start_ssstokes=True,
               save_every=SAVE_EVERY)
    runs, stack_runs = {}, {}
    for wr in (0, 1, "rerun"):
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        o = solve_nse(prob=prob, warm_refine=wr if wr != "rerun" else 0,
                      **dkw)
        torch.cuda.synchronize()
        runs[wr] = (o, counts(), time.time() - t0,
                    torch.cuda.max_memory_allocated())
        stack_runs[wr] = (dict(rect_mv_levels.kernel_launches),
                          dict(rect_mv_levels.stack_launches))
    o0, c0 = runs[0][0], runs[0][1]
    slv = o0["ops"].solver
    require(isinstance(slv, SchurSaddleSolver) and slv.setup == "device"
            and hasattr(o0["ops"], "full_schur"), "the default route at "
            "level 2 is the banded block-Schur solver with its factors "
            "built on the card")
    # every level stack on every kernel form that can take it, and the
    # forms the plan picks at this level
    stack_checks, picked = check_stack_forms(slv, gen)
    for name, levels in (("Wb", 3), ("Xb", 2), ("Sinv", 3)):
        st = getattr(slv, name)
        require(st is not None and st.is_cuda and st.dtype == torch.bfloat16
                and st.shape[1] == levels,
                f"level 2 {name}: {levels} bf16 levels on the card")
    again = runs.pop("rerun")
    require(again[1] == c0, "launches of the level-2 rerun")
    rerun_diff = rel(again[0]["v"], o0["v"])
    require(rerun_diff == 0.0 and torch.equal(again[0]["v"], o0["v"])
            and torch.equal(again[0]["p"], o0["p"]),
            f"two level-2 runs on the card differ: {rerun_diff:.3e}")
    del again
    # the oracle: the same call on the card's dense route
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ref = solve_nse(prob=prob, linsolver="dense", state_layout="inner",
                    **dkw)
    torch.cuda.synchronize()
    ref_wall = time.time() - t0
    ref_counts = counts()
    ref_peak = torch.cuda.max_memory_allocated()
    # a step: the apply and one refinement round; A v and the continuity
    # rhs (J v, f64) through the affine kernel, the round's residual (K v +
    # J^T q, J v) through its fused form, one launch
    require(ref_counts == dict(vecmat=2 * nsteps, conv_vector=nsteps + 3,
                               conv_vector_amatvec=0, affine_mv=2 * nsteps,
                               affine_residual=nsteps, elem_mv=0,
                              **NONE_BANDED),
            f"launches of the level-2 dense run: {ref_counts}")
    require(ref["ffflag"] is False, "level-2 dense run")
    ref_div = divergence_rel(prob, ref["v"])
    rows = {}
    for wr, (o, c, wall_s, peak) in runs.items():
        want = dict(vecmat=0, conv_vector=nsteps + 4, conv_vector_amatvec=0,
                    banded_mv=nsteps * (1 + wr),
                    rect_mv=nsteps * (1 + 3 * wr),
                    rect_mv_levels=nsteps * 3 * (1 + wr), affine_mv=0,
                    affine_residual=0,
                elem_mv=0)
        require(c == want, f"launches of the level-2 run, warm_refine={wr}:"
                f" {c} != {want}")
        by_form, by_shape = stack_runs[wr]
        want_shape, want_form = stack_counts_want(slv, picked, nsteps, wr)
        require(by_shape == want_shape and by_form == want_form,
                f"rect_mv_levels launches of the level-2 run, warm_refine="
                f"{wr}: by stack {by_shape} != {want_shape}, by kernel form "
                f"{by_form} != {want_form}")
        require(o["ffflag"] is False and o["v"].is_cuda
                and o["v"].dtype == torch.float64, "level-2 run")
        for k in ("v", "p", "vs", "ps"):
            require(bool(torch.isfinite(o[k]).all()), f"{k} not finite")
        div = divergence_rel(prob, o["v"])
        require(div <= 1e-6, f"level-2 run, warm_refine={wr}: divergence "
                f"residual {div:.3e}")
        e = {k: rel(o[k], ref[k]) for k in ("v", "p", "vs", "ps")}
        bar = 1e-6 if wr else 1e-4
        require(e["v"] <= bar and e["vs"] <= bar,
                f"level-2 run, warm_refine={wr}, vs the dense route: {e}")
        t = o["timing"]
        rows[wr] = dict(
            launches=c, rect_mv_levels_by_form=by_form,
            wall_seconds=wall_s, setup_seconds=t["setup_s"],
            solver_parts_seconds=o["ops"].solver.setup_timing,
            bootstrap_seconds=t["bootstrap_s"], loop_seconds=t["loop_s"],
            ms_per_step=1e3 * t["loop_s"] / nsteps,
            divergence_residual_rel=div, rel_err_vs_dense_route=e, bar=bar,
            peak_device_mem_bytes=peak)
    # the kernels on the operands of this path: the dense route's inverse
    # under M v of its final state, the level-2 solver's blocks under
    # seeded vectors, the level-2 convection tables
    KinvT = ref["ops"].solver.KinvT
    n2 = KinvT.shape[0]
    x_ref = torch.zeros(n2, dtype=torch.float32, device=dev)
    x_ref[: len(prob.invinds)] = torch.as_tensor(
        (prob.Mc @ ref["v"].cpu().numpy()).astype(np.float32), device=dev)
    vec_check = check_vecmat(x_ref, KinvT, "level-2 inverse of the dense "
                             "run", 20)
    del ref, KinvT
    band_checks = check_band(band_forms(slv, gen), counted=False)
    aff = AffineVectorOps.build(prob, torch.float32, full_dofs=True)
    u, u2 = (torch.randn(prob.nv_full, generator=gen,
                         dtype=torch.float64).to(dev) for _ in range(2))
    conv_checks = check_conv(prob.conv_kernel_on(torch.float32), aff,
                             aff.fac_dofs, u, u2, "random, level 2",
                             bool(prob.gradvsymmtrc), True)
    say(phase="level2_path", problem=f"cylinderwake level {LEVEL2}, Re 100",
        call="solve_nse(prob, t0, tE, Nts=300, start_ssstokes=True, "
             "save_every=60, warm_refine=0|1)",
        nv_full=prob.nv_full, nin=len(prob.invinds), np_cond=prob.np_cond,
        problem_seconds=problem_s, steps=nsteps,
        solver=dict(setup=slv.setup, bs=slv._bs, nblk=slv._nblk, ww=slv._ww,
                    wx=slv._wx, ncg=slv.ncg, Wb=list(slv.Wb.shape),
                    Xb=list(slv.Xb.shape), Sinv=list(slv.Sinv.shape),
                    Jb=list(slv.Jb.shape), JTb=list(slv.JTb.shape),
                    Eblk=list(slv.Eblk.shape)),
        warm_refine_0=rows[0], warm_refine_1=rows[1],
        rel_diff_v_to_first_run=rerun_diff,
        dense_route=dict(launches=ref_counts, wall_seconds=ref_wall,
                         peak_device_mem_bytes=ref_peak,
                         divergence_residual_rel=ref_div,
                         inverse_shape=[n2, n2]),
        vecmat=vec_check, banded=band_checks,
        level_stack_forms=stack_checks, stack_plan_picks=picked,
        convection=conv_checks)

    def band_row(name, operand, launches):
        chk = next(c for c in band_checks
                   if c["name"] == name and c["operand"] == operand)
        return dict(name=f"{name}{STACK_ROWS.get(operand, '')}_level2",
                    route="cuda",
                    source="dolfin_navier_scipy_tpu_torch/csrc/bandmv.cu",
                    replaces=(SAPPLY if operand.startswith("S^-1")
                              else BAND_REPLACES[name]), launches=launches,
                    operand=operand, shape=chk["shape"],
                    max_abs_err=chk["max_abs_err"], ms=chk["ms"],
                    plain_ms=chk["plain_ms"], bound_ms=chk["bound_ms"],
                    bound_by=chk["bound_by"], library_ms=chk["library_ms"],
                    library_eager_ms=chk.get("library_eager_ms"),
                    library=chk["library"], eager_ms=chk["eager_ms"],
                    kernel=chk["kernel"], design=BAND_DESIGN[chk["kernel"]])

    conv = next(c for c in conv_checks if c["form"] == "vector")
    return ref_counts["affine_residual"], [
        dict(name="vecmat_level2", route="cuda",
             source="dolfin_navier_scipy_tpu_torch/csrc/vecmat.cu",
             replaces="dolfin_navier_scipy_tpu/ops/pallas_kernels.py:31",
             launches=ref_counts["vecmat"], shape=vec_check["shape"],
             max_abs_err=vec_check["max_abs_err"], ms=vec_check["ms"],
             plain_ms=vec_check["plain_ms"], bound_ms=vec_check["bound_ms"],
             bound_by=vec_check["bound_by"],
             library_ms=vec_check["library_ms"],
             library_eager_ms=vec_check.get("library_eager_ms"),
             eager_ms=vec_check["eager_ms"], design=DESIGN),
        dict(name="convection_vector_level2", route="cuda",
             source="dolfin_navier_scipy_tpu_torch/csrc/convection.cu",
             replaces="tools/probe_pallas_gather.py:14",
             launches=c0["conv_vector"],
             shape=dict(nc=conv["nc"], nv_full=conv["nv_full"],
                        tables=conv["tables"], state=conv["state"]),
             max_abs_err=conv["max_abs_err"], ms=conv["ms"],
             plain_ms=conv["plain_ms"], bound_ms=conv["bound_ms"],
             bound_by=conv["bound_by"], library_ms=None,
             eager_ms=conv["eager_ms"], design=DESIGN),
        band_row("banded_mv", "E band (explicit A)", c0["banded_mv"]),
        band_row("rect_mv", "J", c0["rect_mv"]),
        *(band_row("rect_mv_levels", label,
                   stack_runs[0][1][tuple(t.shape)])
          for label, t in (("W, 3 bf16 levels", slv.Wb),
                           ("X, 2 bf16 levels", slv.Xb),
                           ("S^-1, 3 bf16 levels", slv.Sinv)))]

# ---------------------------------------------------------------------------
# the affine element matvecs (csrc/affine.cu) and the control slice
# ---------------------------------------------------------------------------

AFFINE_REPLACES = "dolfin_navier_scipy_tpu/ops/affine.py:54"
AFFINE_DESIGN = ("element blocks: a chunk and its halo in shared memory, "
                 "no grid-wide wait")
# plan settings that cut the elements into chunks of one (the held-against
# partition: every chunk gives the same bits)
AFFINE_ONE_CHUNK = dict(MIN_CHUNK=1, BLOCKS_PER_SM=10**6)
AFFINE_MODES = (("m", 1.0, 0.0), ("a", 0.0, 1.0), ("ma", 1.0, 5e-4),
                ("j", 1.0, 0.0), ("jt", 1.0, 0.0), ("res", 1.0, 5e-4))
# the vector type each mode gets on the paths: the f64 carry under A v, f32
# work vectors under M dv and the dense solver's residual; J v of the
# continuity rhs is f64 on f64 tables (timed there)
AFFINE_STATE = dict(m=torch.float32, a=torch.float64, ma=torch.float32,
                    j=torch.float32, jt=torch.float32, res=torch.float32)
# the box behind the cylinder the observation operator averages over
WAKE_BOX = dict(xmin=0.3, xmax=0.5, ymin=0.1, ymax=0.3)


def abs_tables(aff):
    """The affine tables with every entry replaced by its absolute value:
    the plain version on them, under ``|x|``, bounds each output row by the
    sum of the absolute products it adds (every quadrature-point term of
    every element and facet row) — the scale of that row's rounding."""
    t = copy.copy(aff)
    for k in ("W2", "W2T", "MrefI2", "N1q", "JinvT", "wdet", "detJ",
              "fac_elem"):
        setattr(t, k, getattr(aff, k).abs())
    return t


def affine_bound_ms(t, mode, x_item, facets):
    """Least time for one affine call on tables ``t``: the vectors, the
    int32 dof tables, the geometry (``JinvT``, ``wdet``, ``detJ``), the
    reference tables and the facet blocks read once and the output written
    once over the memory rate; the multiply-adds of the per-point chain,
    the facet rows and the reduction over the rate of the work type.
    ``res``: the three matvecs of the residual, sharing the gathers."""
    s = t.wdet.element_size()
    nc, Q, dim, nvpc, pn = t.nc, t.Q, t.dim, t.nvpc, t.pnpc
    nd = nvpc * dim
    nfac = int(t.fac_elem.shape[0]) if facets else 0
    nin = dict(jt=t.npc, res=t.nin + t.npc).get(mode, t.nin)
    nout = dict(j=t.npc, res=t.nin + t.npc).get(mode, t.nin)
    ids = dict(jt=pn, res=nd + pn).get(mode, nd)
    nbytes = (x_item * (nin + nout) + 4 * nc * ids
              + s * nc * (dim * dim + Q + (mode in ("m", "ma", "res")))
              + s * Q * (nvpc * (1 + dim) + pn + 1)
              + nfac * nd * (s * nd + 4))
    grad = 2 * nvpc * dim * dim + 2 * dim ** 3
    per_q = dict(
        m=2 * nvpc * dim + 2 * nvpc * dim + dim + 2,
        a=grad + 4 * dim ** 3 + 2 * nvpc * dim * dim,
        j=grad + dim + 2 * pn,
        jt=2 * pn + 2 * nvpc * dim * dim + 2 * nvpc * dim)
    per_q["ma"] = per_q["a"] + per_q["m"]
    per_q["res"] = per_q["ma"] + per_q["jt"] + dim + 2 * pn
    out_terms = dict(j=pn, res=2 * nd + pn).get(mode, nd)
    flops = nc * Q * per_q[mode] + 2 * nfac * nd * nd + nc * out_terms
    rate = F32_FLOP_PER_S if s == 4 else F64_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


@contextlib.contextmanager
def affine_plan_set(**keys):
    """Every affine plan made inside takes these ``_AFFINE_PLAN`` keys."""
    shipped = dict(kernels._AFFINE_PLAN)
    kernels._AFFINE_PLAN.update(keys)
    try:
        yield
    finally:
        kernels._AFFINE_PLAN.update(shipped)


@contextlib.contextmanager
def affine_wide_slots(rows=16):
    """Every affine partition made inside has its slot table padded to
    ``rows`` rows (-1), past the 12 the kernel holds in registers: the
    kernel then reads every dof's slots from the table."""
    fit = kernels.affine_fit

    def padded(t, kind, chunk, smem_max=None):
        part, chunk, smem = fit(t, kind, chunk, smem_max)
        lell = part["lell"]
        pad = np.full((rows - lell.shape[0], lell.shape[1]), -1, lell.dtype)
        return dict(part, lell=np.concatenate([lell, pad])), chunk, smem

    kernels.affine_fit = padded
    try:
        yield
    finally:
        kernels.affine_fit = fit


def fresh_tables(aff):
    """The tables without their launch plans (another chunk makes its
    own)."""
    t = copy.copy(aff)
    t._plans = {}
    return t


def check_affine(aff, prob, full_dofs, what, gen, timed=None, counted=False,
                 chunks=False):
    """The affine kernel in every mode, and the fused residual ('res'),
    against its plain version on the same inputs (f32 and f64 vectors):
    both sum at most a few hundred products of one row in another order;
    the bar is 1e-5 of the row's sum of the absolute products
    (:func:`abs_tables`; as for the banded kernels).  Two launches must give
    the same bits; 'res' is also compared with the composition of three
    launches it replaces (its bits recorded).  ``timed``: ``{mode: vector
    type}`` to time — the kernel (graph replay and eager), an empty kernel
    on its grid (the floor), its plain version, the one-call library
    equivalent (a cuSPARSE CSR matvec with the assembled matrix; none for
    'res', whose three-launch composition is timed instead) and the bound.
    ``counted``: one device kernel a call, not cooperative, and a graph
    replay with the eager call's bits, in every mode.  ``chunks``: the
    kernel on chunks of one element (another partition of the same
    elements) and with slot tables wider than its registers (its other
    path) must give the bits of the plan's chunk."""
    timed = timed or {}
    dev = aff.wdet.device
    absaff = abs_tables(aff)
    # the assembled matrices, for the library's one-call equivalent
    f = prob.full
    M, A, J, JT = ((f["M"], f["A"], f["J"], f["JT"]) if full_dofs
                   else (prob.Mc, prob.Ac, prob.Jc, prob.JTc))
    out = []
    for mode, cm, ca in AFFINE_MODES:
        n = aff.npc if mode == "jt" else aff.nin
        for xdt in (torch.float32, torch.float64):
            x = torch.randn(n, generator=gen, dtype=torch.float64)
            qv = torch.randn(aff.npc, generator=gen, dtype=torch.float64)
            xd = x.to(device=dev, dtype=xdt)
            qd = qv.to(device=dev, dtype=xdt)

            def run(t=aff, xd=xd, qd=qd, mode=mode, cm=cm, ca=ca):
                if mode == "res":
                    return affine_residual(xd, qd, t, cm, ca)
                return affine_mv(mode, xd, t, cm, ca)

            def plain(xd=xd, qd=qd, mode=mode, cm=cm, ca=ca):
                if mode == "res":
                    return affine_residual_ref(xd, qd, aff, cm, ca)
                return affine_mv_ref(mode, xd, aff, cm, ca)

            y, again = run(), run()
            ref = plain()
            torch.cuda.synchronize()
            require(y.dtype == xdt and y.shape == ref.shape,
                    f"affine {mode}: output type")
            require(bool(torch.isfinite(y).all()), f"affine {mode} not "
                    "finite")
            if mode == "res":
                rowbar = 1e-5 * affine_residual_ref(
                    xd.double().abs(), qd.double().abs(), absaff, cm, ca)
            else:
                rowbar = 1e-5 * affine_mv_ref(mode, xd.double().abs(),
                                              absaff, abs(cm), abs(ca))
            rowbar = rowbar + 1e-30
            err = (y.double() - ref.double()).abs()
            ratio = float((err / rowbar).max())
            require(ratio <= 1.0, f"affine kernel ({mode}, {what}, {xdt}) "
                    f"disagrees with its plain version: worst ratio to the "
                    f"row bar {ratio:.3e}")
            require(torch.equal(y, again), f"affine kernel ({mode}, {what}) "
                    "is not reproducible launch to launch")
            plan = aff._plans[dev.index]
            chunk = plan.call(mode, cm, ca, xdt).chunk
            row = dict(name="affine_mv", mode=mode, operand=what,
                       tables=str(aff.wdet.dtype), state=str(xdt),
                       nc=aff.nc, nin=aff.nin, npc=aff.npc, chunk=chunk,
                       facet_blocks=int(aff.fac_elem.shape[0]),
                       max_abs_err=float(err.max()),
                       max_err_over_row_bar=ratio,
                       max_abs_ref=float(ref.abs().max()))
            if mode == "res":
                comp = torch.cat([
                    affine_mv("ma", xd, aff, cm, ca) + affine_mv("jt", qd,
                                                                 aff),
                    affine_mv("j", xd, aff)])
                row.update(name="affine_residual",
                           equals_composition_bits=bool(torch.equal(y, comp)),
                           vs_composition_max_abs=float(
                               (y.double() - comp.double()).abs().max()))
            if counted:
                coop = []
                types, replayed = captured(run, coop)
                ran = types.count(0)
                require(ran == 1 and coop in ([False], [None]),
                        f"affine kernel ({mode}, {what}) ran {ran} device "
                        f"kernels, cooperative {coop} (graph node types "
                        f"{types})")
                require(torch.equal(replayed, y), f"affine kernel ({mode}, "
                        f"{what}): a graph replay differs from the eager "
                        "call")
                row.update(device_kernels_per_call=ran,
                           cooperative_launch=coop[0],
                           graph_replay_equal=True)
            if chunks and xdt == torch.float32:
                with affine_plan_set(**AFFINE_ONE_CHUNK):
                    yf = run(fresh_tables(aff))
                require(torch.equal(yf, y), f"affine kernel ({mode}, {what})"
                        f" on chunks of one element: other bits than on "
                        f"chunks of {chunk}")
                with affine_wide_slots():
                    yw = run(fresh_tables(aff))
                require(torch.equal(yw, y), f"affine kernel ({mode}, {what})"
                        f" with slot tables of 16 rows: other bits")
                row.update(chunk_one_same_bits=True, wide_slots_same_bits=True)
            if timed.get(mode) == xdt:
                bound, by = affine_bound_ms(
                    aff, mode, xd.element_size(),
                    mode in ("a", "ma", "res") and ca != 0.0)
                row.update(ms=graph_ms(run), eager_ms=time_ms(run, 200),
                           floor_ms=graph_ms(lambda: _affine_launch(
                               mode, xd, qd if mode == "res" else None, aff,
                               cm, ca, empty=True)),
                           plain_ms=time_ms(plain, 50), bound_ms=bound,
                           bound_by=by)
                if mode == "res":
                    # the library's one call: the assembled saddle
                    # operator [[cm M + ca A, J^T], [J, 0]] on [v; q]
                    B = sps.bmat([[cm * M + ca * A, JT], [J, None]])
                    xl = torch.cat([xd, qd])
                    row.update(composition_ms=graph_ms(lambda: torch.cat([
                        affine_mv("ma", xd, aff, cm, ca)
                        + affine_mv("jt", qd, aff),
                        affine_mv("j", xd, aff)])))
                else:
                    B = dict(m=M, a=A, j=J, jt=JT,
                             ma=cm * M + ca * A)[mode]
                    xl = xd
                B = sps.csr_matrix(B)
                csr = torch.sparse_csr_tensor(
                    torch.as_tensor(B.indptr, dtype=torch.int64),
                    torch.as_tensor(B.indices, dtype=torch.int64),
                    torch.as_tensor(B.data), size=B.shape).to(
                        device=dev, dtype=aff.wdet.dtype)
                xl = xl.to(aff.wdet.dtype)[:, None]
                row.update(**library_times(lambda: csr @ xl),
                           library="cuSPARSE CSR matvec (torch sparse CSR @) "
                                   "with the assembled matrix" + (
                                       " (the saddle operator)"
                                       if mode == "res" else ""))
                row["roofline_share"] = bound / row["ms"]
            out.append(row)
    return out


def affine_rows(checks, suffix, launches):
    """The ``kernels`` line's rows of the affine kernel: one per mode of
    the timed checks, with that mode's launches on its path."""
    rows = []
    for c in checks:
        if "ms" not in c or c["mode"] not in launches:
            continue
        name = ("affine_residual" if c["mode"] == "res"
                else f"affine_mv_{c['mode']}")
        rows.append(dict(
            name=name + suffix, route="cuda",
            source="dolfin_navier_scipy_tpu_torch/csrc/affine.cu",
            replaces=AFFINE_REPLACES, launches=launches[c["mode"]],
            mode=c["mode"], operand=c["operand"],
            shape=dict(nc=c["nc"], nin=c["nin"], npc=c["npc"],
                       facet_blocks=c["facet_blocks"], tables=c["tables"],
                       state=c["state"]),
            max_abs_err=c["max_abs_err"], ms=c["ms"], plain_ms=c["plain_ms"],
            bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"], library=c["library"],
            library_eager_ms=c.get("library_eager_ms"),
            eager_ms=c["eager_ms"], floor_ms=c["floor_ms"],
            composition_ms=c.get("composition_ms"),
            device_kernels_per_call=c.get("device_kernels_per_call"),
            chunk=c["chunk"], design=AFFINE_DESIGN))
    return rows


def schur_inner_counts(nsteps, refine, affine_per_step, smw_cols=0):
    """Launches of an inner-layout run on the banded Schur solver with W:
    a step's convection vector, its ``affine_per_step`` affine matvecs (A v
    and the continuity rhs's f64 J v; sbdf2 also M dv), the solve (W, J,
    S^-1, X) and per refine round the residual (F, J^T, J) and a second
    solve; the Heun bootstrap's three convection vectors; the SMW setup's
    ``smw_cols`` column solves (with the same refine rounds)."""
    solves = nsteps + smw_cols
    return dict(vecmat=0, conv_vector=nsteps + 3, conv_vector_amatvec=0,
                banded_mv=solves * refine,
                rect_mv=solves * (1 + 3 * refine),
                rect_mv_levels=3 * solves * (1 + refine),
                affine_mv=affine_per_step * nsteps, affine_residual=0,
                elem_mv=0)


def rot_control(prob, dev):
    """The rotating cylinder of the problem (``movingwallcntrl``) as a
    :class:`DirichletControl`: ``sin(20 t)`` times its tangent stencil."""
    dofs, stencil = prob.dircntrl[0]
    return [DirichletControl(dofs, stencil,
                             lambda t, v, p, mem, mode: (math.sin(20.0 * t),
                                                         mem))]


def control_path(dev, gen, nsteps):
    """The control slice at level 1 on the default (block-Schur) route,
    inner state layout: (a) the rotating cylinder, a Dirichlet control
    ``sin(20 t)``; (b) Robin control through ``f_tdp`` on a
    Robin-penalized problem; (c) static feedback ``umat = -0.5 C^T``,
    ``vmat = C`` over the SMW-wrapped solver; (d) ``sbdf2`` with the control
    of (a) — each with ``warm_refine`` 0 and 1, against the port's CPU f64
    run of the same call on the exact (dense) solver: 1e-6 refined, 1e-4
    unrefined; divergence, a bitwise rerun, the control values, exact
    launch counts.  Then the affine kernel on the Robin tables.  Returns
    the affine kernel's launches by mode in (a) and (d)."""
    t0 = time.time()
    rot = cylinderwake_problem(level=LEVEL, Re=RE, charvel=CHARVEL,
                               movingwallcntrl=True)
    rob = cylinderwake_problem(level=LEVEL, Re=RE, charvel=CHARVEL,
                               bccontrol=True)
    Brob = apply_robin_penalty(rob, palpha=1e-3)
    problems_s = time.time() - t0
    C = observation_operator(rot, odcoo=WAKE_BOX, ny=4)[:, rot.invinds]
    bdiff = (Brob[:, 0] - Brob[:, 1]).ravel()

    def robin_f(device):
        fv = torch.as_tensor(rob.fv.ravel(), device=device)
        bd = torch.as_tensor(bdiff, device=device)
        return lambda t: fv + math.sin(10.0 * t) * bd

    trange_end = float(np.linspace(T0, TE, NTS + 1)[-1])
    dkw = dict(t0=T0, tE=TE, Nts=NTS, start_ssstokes=True,
               save_every=SAVE_EVERY)
    cases = dict(
        a=(rot, "cnab", lambda d: dict(controls=rot_control(rot, d)), 2, 0),
        b=(rob, "cnab", lambda d: dict(f_tdp=robin_f(d)), 2, 0),
        c=(rot, "cnab", lambda d: dict(umat=-0.5 * C.T, vmat=C), 2,
           C.shape[0]),
        d=(rot, "sbdf2", lambda d: dict(controls=rot_control(rot, d)), 3, 0))
    rows, mode_launches, cpu_ops = {}, {}, {}
    stencil = torch.as_tensor(np.asarray(rot.dircntrl[0][1]).ravel(),
                              device=dev)
    for name, (prob, scheme, extra, aff_per_step, ncols) in cases.items():
        # the port's CPU f64 run of the same call on the exact solver
        okey = (id(prob), scheme)
        t0 = time.time()
        before = counts()
        ref = solve_nse(prob=prob, device="cpu", linsolver="dense",
                        time_int_scheme=scheme, ops=cpu_ops.get(okey),
                        **extra("cpu"), **dkw)
        require(counts() == before, "the CPU run launched a kernel")
        cpu_ops.setdefault(okey, ref["ops"])
        cpu_s = time.time() - t0
        require(ref["ffflag"] is False, f"control {name}: CPU run")
        row = dict(scheme=scheme, cpu_f64_seconds=cpu_s)
        ops = None
        for wr in (0, 1):
            zero_counts()
            t0 = time.time()
            o = solve_nse(prob=prob, time_int_scheme=scheme, warm_refine=wr,
                          ops=ops, **extra(dev), **dkw)
            torch.cuda.synchronize()
            wall = time.time() - t0
            c = counts()
            slv = o["ops"].solver
            require(isinstance(getattr(slv, "base", slv), SchurSaddleSolver),
                    f"control {name}: the default route is the Schur solver")
            if ncols == 0:
                # the next runs reuse the solver (an SMW-wrapped one is
                # built anew: cnab wraps what it is given)
                ops = o["ops"]
            want = schur_inner_counts(nsteps, wr, aff_per_step, ncols)
            div = divergence_rel(prob, o["v"], o["carry"]["gp"])
            e = {k: rel(o[k], ref[k]) for k in ("v", "p", "vs", "ps")}
            bar = 1e-6 if wr else 1e-4
            # each run's numbers before its checks
            say(phase="control_path_run", case=name, warm_refine=wr,
                rel_err_vs_cpu_f64=e, divergence_residual_rel=div,
                launches=c)
            require(c == want, f"launches of control {name}, warm_refine="
                    f"{wr}: {c} != {want}")
            if name in ("a", "d") and wr == 0:
                mode_launches[name] = dict(affine_mv.mode_launches)
            require(o["ffflag"] is False and o["v"].is_cuda
                    and o["v"].dtype == torch.float64, f"control {name}")
            for k in ("v", "p", "vs", "ps"):
                require(bool(torch.isfinite(o[k]).all()),
                        f"control {name}: {k} not finite")
            require(div <= 1e-6, f"control {name}, warm_refine={wr}: "
                    f"divergence residual {div:.3e}")
            require(e["v"] <= bar and e["vs"] <= bar,
                    f"control {name}, warm_refine={wr}, card vs CPU f64: {e}")
            if "controls" in extra("cpu"):
                cv = o["carry"]["cvals"]
                require(torch.equal(cv, math.sin(20.0 * trange_end)
                                    * stencil),
                        f"control {name}: the control dofs do not carry "
                        "sin(20 t_end) * stencil")
            t = o["timing"]
            row[f"warm_refine_{wr}"] = dict(
                launches=c, wall_seconds=wall, setup_seconds=t["setup_s"],
                bootstrap_seconds=t["bootstrap_s"], loop_seconds=t["loop_s"],
                ms_per_step=1e3 * t["loop_s"] / nsteps,
                launches_per_step={k: v / nsteps for k, v in c.items()},
                divergence_residual_rel=div, rel_err_vs_cpu_f64=e, bar=bar)
            if name == "a" and wr == 0:
                zero_counts()
                again = solve_nse(prob=prob, time_int_scheme=scheme,
                                  warm_refine=0, ops=ops, **extra(dev),
                                  **dkw)
                require(counts() == c, "launches of the control rerun")
                require(torch.equal(again["v"], o["v"])
                        and torch.equal(again["p"], o["p"]),
                        "two controlled runs on the card differ: "
                        f"{rel(again['v'], o['v']):.3e}")
                row["rel_diff_v_to_first_run"] = rel(again["v"], o["v"])
                del again
        rows[name] = row
        del ref
    # the affine kernel on the Robin tables: the penalty in the facet rows
    aff_rob = rob.affine_ops(torch.float32, device=dev)
    require(aff_rob.fac_elem.shape[0]
            > AffineVectorOps.build(rot, torch.float32,
                                    device=dev).fac_elem.shape[0],
            "the Robin arcs add facet blocks")
    rob_checks = check_affine(aff_rob, rob, False,
                              "level 1, Robin-penalized", gen)
    say(phase="control_path", problem="cylinderwake level 1, Re 100: (a) "
        "movingwallcntrl, DirichletControl sin(20 t); (b) bccontrol, "
        "apply_robin_penalty(1e-3), f_tdp = fv + sin(10 t)(Brob0 - Brob1); "
        "(c) umat = -0.5 C^T, vmat = C, C = observation_operator(ny=4, "
        f"odcoo={WAKE_BOX}); (d) sbdf2 with (a)",
        call="solve_nse(prob, t0, tE, Nts=300, start_ssstokes=True, "
             "save_every=60, warm_refine=0|1, controls=|f_tdp=|umat=,vmat=)",
        oracle="the same call on the CPU in f64, linsolver='dense'",
        problems_seconds=problems_s, steps=nsteps, runs=rows,
        affine_robin=rob_checks)
    return mode_launches


def busy_share(fn):
    """``(device busy ms, device kernels, wall s)`` of one call of ``fn``
    under ``torch.profiler``; busy None where the profiler saw no device
    event (printed, not checked)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    dev_ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_ev:
        return None, None, wall     # the profiler saw no device event
    return (1e-3 * sum(e.device_time_total for e in dev_ev),
            sum(e.count for e in dev_ev), wall)


def control_level2(dev, gen, nsteps):
    """The control slice at level 2 (full width, device setup; no CPU
    oracle at this size): (a) the rotating cylinder of ``control_path``;
    (b) ``solve_nse(closed_loop=True, dynamic_feedback=True,
    dyn_fb_disc="AB2")`` with a stable observer made from the seed, held
    bitwise against the same run through a hand-built ``dynamic_rhs``;
    (c) static feedback through ``feedbackthroughdict``.  Refine 0 against
    refine 1 within 1e-4, divergence, a bitwise rerun, exact launches.
    Printed: ms and launches a step, the device-busy share of a traced
    run.  Returns the affine kernel's checks at level 2 (f32 tables timed)
    and its launches by mode in (a)."""
    t0 = time.time()
    prob = cylinderwake_problem(level=LEVEL2, Re=RE, charvel=CHARVEL,
                                movingwallcntrl=True)
    problem_s = time.time() - t0
    nin = len(prob.invinds)
    C = observation_operator(prob, odcoo=WAKE_BOX, ny=4)[:, prob.invinds]
    ny, hN = C.shape[0], 4
    rng = np.random.default_rng(SEED)
    dfb = dict(ha=-np.eye(hN) + 0.05 * rng.normal(size=(hN, hN)),
               hb=0.3 * rng.normal(size=(hN, ny)),
               hc=0.05 * rng.normal(size=(ny, hN)), inihx=np.ones(hN))
    # the actuation acts where the observation looks (a random B over
    # every dof would be a grid-scale forcing)
    B = 1e-2 * C.T
    fbtd = {None: dict(mtxtb=0.5 * C.T, w=np.linspace(0.0, 1.0, nin))}
    dkw = dict(t0=T0, tE=TE, Nts=NTS, start_ssstokes=True,
               save_every=SAVE_EVERY)
    ctl = rot_control(prob, dev)
    cases = dict(
        a=(dict(controls=ctl), 0),
        b=(dict(closed_loop=True, dynamic_feedback=True, dyn_fb_dict=dfb,
                dyn_fb_disc="AB2", b_mat=B, cv_mat=C), 0),
        c=(dict(closed_loop=True, static_feedback=True,
                feedbackthroughdict=fbtd, b_mat=1e-2 * C.T), ny))
    rows, ops, outs = {}, None, {}
    for name, (extra, ncols) in cases.items():
        row = {}
        for wr in (0, 1):
            zero_counts()
            t0 = time.time()
            o = solve_nse(prob=prob, warm_refine=wr, ops=ops, **extra, **dkw)
            torch.cuda.synchronize()
            wall = time.time() - t0
            c = counts()
            if ops is None:
                ops = o["ops"]
                require(isinstance(ops.solver, SchurSaddleSolver)
                        and ops.solver.setup == "device",
                        "level-2 controls: the Schur solver, device setup")
                setup_s = o["timing"]["setup_s"]
                iniv, inip = o["iniv"], o["inip"]
                modes = dict(affine_mv.mode_launches)
            want = schur_inner_counts(nsteps, wr, 2, ncols)
            # the first run builds the solver: no launch in a setup
            require(c == want, f"launches of level-2 control {name}, "
                    f"warm_refine={wr}: {c} != {want}")
            require(o["ffflag"] is False, f"level-2 control {name}")
            for k in ("v", "p", "vs", "ps"):
                require(bool(torch.isfinite(o[k]).all()),
                        f"level-2 control {name}: {k} not finite")
            div = divergence_rel(prob, o["v"], o["carry"]["gp"])
            require(div <= 1e-6, f"level-2 control {name}, warm_refine="
                    f"{wr}: divergence residual {div:.3e}")
            t = o["timing"]
            row[f"warm_refine_{wr}"] = dict(
                launches=c, wall_seconds=wall,
                bootstrap_seconds=t["bootstrap_s"], loop_seconds=t["loop_s"],
                ms_per_step=1e3 * t["loop_s"] / nsteps,
                launches_per_step={k: v / nsteps for k, v in c.items()},
                divergence_residual_rel=div)
            outs[name, wr] = o
        e = rel(outs[name, 0]["v"], outs[name, 1]["v"])
        require(e <= 1e-4, f"level-2 control {name}: refine 0 vs refine 1 "
                f"{e:.3e}")
        row["rel_v_refine0_vs_refine1"] = e
        rows[name] = row
    # (a) again: the same bits
    zero_counts()
    again = solve_nse(prob=prob, warm_refine=0, ops=ops, **cases["a"][0],
                      **dkw)
    require(torch.equal(again["v"], outs["a", 0]["v"])
            and torch.equal(again["p"], outs["a", 0]["p"]),
            "two level-2 controlled runs differ")
    rows["a"]["rel_diff_v_to_first_run"] = rel(again["v"], outs["a", 0]["v"])
    del again
    # (b) against the hand-built dynamic_rhs: the same bits
    fbk, mem0 = get_heunab_lti(hb=dfb["hb"], ha=dfb["ha"], hc=dfb["hc"],
                               inihx=dfb["inihx"], device=dev)
    Bt, Ct = (torch.as_tensor(m, device=dev) for m in (B, C))

    def dynamic_rhs(t, vc=None, memory=None, mode=None):
        u, memory = fbk(t, vc=Ct @ vc, memory=memory, mode=mode)
        return Bt @ u, memory

    hand = solve_nse(prob=prob, warm_refine=1, ops=ops,
                     dynamic_rhs=dynamic_rhs, dynamic_rhs_memory=mem0, **dkw)
    require(torch.equal(hand["v"], outs["b", 1]["v"])
            and torch.equal(hand["p"], outs["b", 1]["p"]),
            "closed_loop dynamic feedback differs from the hand-built "
            f"dynamic_rhs: {rel(hand['v'], outs['b', 1]['v']):.3e}")
    del hand, outs
    # a traced run of (a), refine 0 (printed, not checked): device time
    # over the untraced run's loop time
    busy, nk, wall = busy_share(lambda: solve_nse(
        prob=prob, t0=T0, tE=TE, Nts=NTS, iniv=iniv, inip=inip, ops=ops,
        controls=ctl, save_every=0))
    loop_a = rows["a"]["warm_refine_0"]["loop_seconds"]
    # the affine kernel on the level-2 tables (A v under the f64 carry)
    aff = prob.affine_ops(torch.float32, device=dev)
    checks = check_affine(aff, prob, False, "level 2", gen,
                          timed=AFFINE_STATE)
    checks += check_affine(prob.affine_ops(torch.float64, device=dev), prob,
                           False, "level 2", gen)
    say(phase="control_level2", problem=f"cylinderwake level {LEVEL2}, "
        "Re 100, movingwallcntrl: (a) DirichletControl sin(20 t); (b) "
        "closed_loop dynamic_feedback AB2, hN 4 (hA, hB, hC seeded), C = "
        f"observation_operator(ny=4, odcoo={WAKE_BOX}), B = 1e-2 C^T; (c) "
        "closed_loop static_feedback "
        "feedbackthroughdict (mtxtb = 0.5 C^T, b_mat = 1e-2 C^T)",
        nin=nin, np_cond=prob.np_cond, problem_seconds=problem_s,
        solver_setup_seconds=setup_s,
        solver_parts_seconds=ops.solver.setup_timing, steps=nsteps,
        runs=rows, closed_loop_equals_hand_built=True,
        traced_run_a=dict(
            device_busy_ms=busy, device_kernels=nk, traced_wall_seconds=wall,
            note="bootstrap included (host splu; three convection kernels)",
            device_busy_ms_per_step=(None if busy is None
                                     else busy / nsteps),
            device_busy_share_of_untraced_loop=(
                None if busy is None else 1e-3 * busy / loop_a)),
        affine=checks)
    return checks, modes


# ---------------------------------------------------------------------------
# the steady slice: the element-matrix matvec (B10) and the steady routes
# ---------------------------------------------------------------------------

ELEM_REPLACES = dict(
    sk="dolfin_navier_scipy_tpu/solve/steady.py:369",
    op="dolfin_navier_scipy_tpu/ops/elementop.py:48",
    div="dolfin_navier_scipy_tpu/ops/elementop.py:87")
ELEM_DESIGN = ("blocks own the output dofs of chunks of elements in RCM "
               "order: the block's tables by one bulk copy and its distinct "
               "inputs into shared memory, a thread an element row read "
               "from E by 16-byte loads, a thread a dof summing its rows in "
               "slot order; no scratch, no atomics, no grid barrier")
# sha256 (first 16 hex digits) of y from the earlier kernel of
# csrc/elemmv.cu (a thread an output dof, commit 18d2655) on the seeded
# operands of elem_bits_cases: the redesigned kernel sums in its order, so
# it must give these bits (tools_torch/elemmv_variants.py prints them for
# any checkout)
ELEM_BITS = {
    "velocity 12x12, E float32, x float32": "f70656f1c0d254f6",
    "velocity 12x12, E float64, x float64": "b92352d9dccfbca0",
    "velocity 12x12, E float64, x float32": "358eb944e91cc517",
    "J 3x12, E float32, x float32": "f3ef5b10e49eb50f",
    "J 3x12, E float64, x float64": "f2f5bf8dd4edfc14",
    "J 3x12, E float64, x float32": "f156d982ca37baa1",
    "J^T, E float32, x float32": "1abf71fb737d76ba",
    "J^T, E float64, x float64": "60710fd96b27ec34",
    "J^T, E float64, x float32": "d07f05317b3a27f4"}
DFG_REF = dict(cd=5.57953523384, cl=0.010618948146, dp=0.11752016697)
STEADY_KW = dict(return_vp=True, vel_pcrd_stps=2, vel_nwtn_stps=8,
                 vel_nwtn_tol=1e-12, return_nwtnupd_norms=True,
                 verbose=False)


def dfg_problem(level):
    """The DFG 2D-1 steady benchmark (Re 20) at a mesh level."""
    return cylinderwake_problem(level=level, nu=1e-3, charvel=0.2)


def elem_bound_ms(E, x, in_tab, out_tab, transpose):
    """Bytes (E, the input ids, the output ids, x, y; each once, and the
    ids once where input and output share a table: the kernel's own slot
    tables are its design, not the function's) over the memory rate
    against 2 nc R C operations over the peak rate of x's type;
    ``(ms, by)``."""
    R, C = (E.shape[2], E.shape[1]) if transpose else E.shape[1:]
    ids = in_tab.vd.numel() + (0 if out_tab is in_tab
                               else out_tab.vd.numel())
    nbytes = (E.numel() * E.element_size() + 4 * ids
              + x.element_size() * (x.numel() + out_tab.nseg))
    ops = 2.0 * E.shape[0] * R * C
    peak = F64_FLOP_PER_S if x.dtype == torch.float64 else F32_FLOP_PER_S
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def elem_csr(E, in_tab, out_tab, transpose, dtype, dev):
    """The assembled matrix of the element blocks as a CUDA CSR tensor
    (the library's one-call equivalent: a cuSPARSE matvec)."""
    Ed = E.double().cpu().numpy()
    if transpose:
        Ed = Ed.transpose(0, 2, 1)
    ri = out_tab.vd.cpu().numpy()[:, :, None]
    ci = in_tab.vd.cpu().numpy()[:, None, :]
    rows = np.broadcast_to(ri, Ed.shape).ravel()
    cols = np.broadcast_to(ci, Ed.shape).ravel()
    keep = (rows < out_tab.nseg) & (cols < in_tab.nseg)
    B = sps.csr_matrix((Ed.ravel()[keep], (rows[keep], cols[keep])),
                       shape=(out_tab.nseg, in_tab.nseg))
    return torch.sparse_csr_tensor(
        torch.as_tensor(B.indptr, dtype=torch.int64),
        torch.as_tensor(B.indices, dtype=torch.int64),
        torch.as_tensor(B.data), size=B.shape).to(device=dev, dtype=dtype)


def check_elem(E, in_tab, out_tab, transpose, what, gen, replaces):
    """B10 against its plain version on the same inputs: 1e-6 relative in
    f32, 1e-12 in f64; one kernel node a call, the same bits on a rerun and
    a graph replay; timed by graph replay beside its plain version, a
    cuSPARSE CSR matvec of the assembled matrix and the bound."""
    dev = E.device
    x = torch.randn(in_tab.nseg, generator=gen, dtype=torch.float64).to(
        device=dev, dtype=E.dtype)

    def run():
        return elem_mv(E, x, in_tab, out_tab, transpose)

    def plain():
        return elem_mv_ref(E, x, in_tab, out_tab, transpose)

    before = elem_mv.launches
    y, again = run(), run()
    ref = plain()
    torch.cuda.synchronize()
    require(elem_mv.launches == before + 2, "elem_mv counts its launches")
    require(y.dtype == x.dtype and y.shape == ref.shape, "elem_mv: output")
    require(bool(torch.isfinite(y).all()), f"elem_mv ({what}) not finite")
    err = rel(y, ref)
    bar = 1e-6 if x.dtype == torch.float32 else 1e-12
    require(err <= bar, f"elem_mv ({what}) disagrees with its plain version: "
            f"{err:.3e} > {bar}")
    require(torch.equal(y, again), f"elem_mv ({what}) is not reproducible")
    types, replayed = captured(run)
    require(types.count(0) == 1, f"elem_mv ({what}) ran {types.count(0)} "
            f"device kernels (graph node types {types})")
    require(torch.equal(replayed, y), f"elem_mv ({what}): a graph replay "
            "differs from the eager call")
    csr = elem_csr(E, in_tab, out_tab, transpose, x.dtype, dev)
    xl = x[:, None]
    bound, by = elem_bound_ms(E, x, in_tab, out_tab, transpose)
    ms = graph_ms(run)
    plan = kernels.elem_plan_for(E, x, in_tab, out_tab, transpose)
    return dict(name="elem_mv", operand=what, transpose=transpose,
                plan=plan.describe(),
                shape=list(E.shape), tables=str(E.dtype), state=str(x.dtype),
                n_in=in_tab.nseg, n_out=out_tab.nseg,
                slots_per_dof_max=int(out_tab.kernel_tables()[1].shape[0]),
                rel_err=err, bar=bar,
                max_abs_err=float((y.double() - ref.double()).abs().max()),
                device_kernels_per_call=1, graph_replay_equal=True,
                ms=ms, eager_ms=time_ms(run, 200),
                plain_ms=time_ms(plain, 50),
                **library_times(lambda: csr @ xl),
                library="cuSPARSE CSR matvec (torch sparse CSR @) with the "
                        "assembled matrix",
                bound_ms=bound, bound_by=by, roofline_share=bound / ms,
                replaces=replaces)


def elem_bits_cases(dev):
    """``[(name, E, x, in_tab, out_tab, transpose)]``: seeded numpy blocks
    and vectors on the level-1 DFG 2D-1 tables (the 12x12 velocity blocks,
    J and J^T), f32 blocks and vector, f64 and f64, f64 blocks under an
    f32 vector: bits that depend on the kernel's arithmetic alone."""
    _, A, J = build_element_ops(dfg_problem(1), dtype=torch.float64,
                                device=dev)
    return seeded_elem_cases((
        ("velocity 12x12", A.elem.shape, A.tab, A.tab, False),
        ("J 3x12", J.elem.shape, J.vtab, J.ptab, False),
        ("J^T", J.elem.shape, J.ptab, J.vtab, True)), 20, dev)


def seeded_elem_cases(operands, seed, dev):
    """For each ``(name, E's shape, in_tab, out_tab, transpose)`` of
    ``operands``: blocks and a vector from ``numpy`` seeded with ``seed``,
    in f32 / f32, f64 / f64 and f64 blocks under an f32 vector."""
    rng = np.random.default_rng(seed)
    out = []
    for name, shape, tin, tout, tr in operands:
        for edt, xdt in ((torch.float32, torch.float32),
                         (torch.float64, torch.float64),
                         (torch.float64, torch.float32)):
            E = torch.as_tensor(rng.normal(size=tuple(shape))).to(dev, edt)
            x = torch.as_tensor(rng.normal(size=tin.nseg)).to(dev, xdt)
            out.append((f"{name}, E {str(edt)[6:]}, x {str(xdt)[6:]}", E, x,
                        tin, tout, tr))
    return out


def elem_bits(mv, cases):
    """``{name: the first 16 hex digits of sha256(y)}`` of ``mv`` (an
    ``elem_mv``) on ``cases``."""
    out = {}
    for name, E, x, tin, tout, tr in cases:
        y = mv(E, x, tin, tout, tr)
        out[name] = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
    return out


def elemmv_checks(dev, gen):
    """B10 on every operand it takes: the steady Krylov route's f32 F
    blocks (``_sk_elem32``: stiffness plus linearized convection) at
    levels 1 and 2 at a seeded velocity, ``ElementOp`` M and A with f32
    and f64 tables, and ``DivElementOp`` J and J^T (level 1); and the
    earlier kernel's bits on the seeded operands of ``elem_bits_cases``."""
    out = []
    for level in (1, 2):
        prob = dfg_problem(level)
        sk = SteadyKrylovKernel(prob, device=dev)
        v = torch.randn(prob.nv_full, generator=gen,
                        dtype=torch.float64).to(dev)
        el = _sk_elem32(sk, v, False)
        out.append(check_elem(el, sk.ell_dofs, sk.ell_dofs, False,
                              f"_sk_elem32, level {level}", gen,
                              ELEM_REPLACES["sk"]))
        del sk, el
    prob = dfg_problem(1)
    for dt in (torch.float32, torch.float64):
        M, A, J = build_element_ops(prob, dtype=dt, device=dev)
        for name, op in (("M", M), ("A", A)):
            out.append(check_elem(op.elem, op.tab, op.tab, False,
                                  f"ElementOp {name}, level 1", gen,
                                  ELEM_REPLACES["op"]))
        out.append(check_elem(J.elem, J.vtab, J.ptab, False,
                              "DivElementOp J, level 1", gen,
                              ELEM_REPLACES["div"]))
        out.append(check_elem(J.elem, J.ptab, J.vtab, True,
                              "DivElementOp J^T, level 1", gen,
                              ELEM_REPLACES["div"]))
    bits = elem_bits(elem_mv, elem_bits_cases(dev))
    require(bits == ELEM_BITS, f"elem_mv: other bits than the earlier "
            f"kernel's on the seeded operands: {bits} != {ELEM_BITS}")
    say(phase="elemmv_checks", checks=out, same_bits_as_earlier_kernel=bits)
    return out


def elem_row(c, launches):
    """The ``kernels`` line's row of B10."""
    return dict(
        name="elem_mv", route="cuda",
        source="dolfin_navier_scipy_tpu_torch/csrc/elemmv.cu",
        replaces=c["replaces"], launches=launches, operand=c["operand"],
        shape=dict(E=c["shape"], n_in=c["n_in"], n_out=c["n_out"],
                   tables=c["tables"], state=c["state"]),
        max_abs_err=c["max_abs_err"], ms=c["ms"], plain_ms=c["plain_ms"],
        bound_ms=c["bound_ms"], bound_by=c["bound_by"],
        library_ms=c["library_ms"], library=c["library"],
            library_eager_ms=c.get("library_eager_ms"),
        eager_ms=c["eager_ms"],
        device_kernels_per_call=c["device_kernels_per_call"],
        plan=c["plan"], design=ELEM_DESIGN)


def dfg_checked(prob, v, p, what):
    """Cd, Cl, dp and the divergence of a steady solution, held to the
    bars of ``tests/test_dfg_benchmark.py`` (Cd 0.5 %, Cl 2e-3 absolute,
    dp 1 % of the published values) and divergence <= 1e-9."""
    cl, cd = LiftDragSurfForce(prob).coefficients(v, p, charvel=0.2,
                                                   charlen=0.1)
    coef = dict(cd=float(cd), cl=float(cl), dp=pressure_drop(prob, p))
    require(abs(coef["cd"] - DFG_REF["cd"]) / DFG_REF["cd"] < 0.005
            and abs(coef["cl"] - DFG_REF["cl"]) < 2e-3
            and abs(coef["dp"] - DFG_REF["dp"]) / DFG_REF["dp"] < 0.01,
            f"DFG 2D-1 coefficients ({what}) {coef} vs {DFG_REF}")
    div = float(np.abs(prob.Jc @ v.ravel()[prob.invinds]
                       - prob.fp.ravel()).max())
    require(div <= 1e-9, f"divergence ({what}) {div:.3e}")
    return coef, div


def dense_step_ms(prob, dev, v):
    """Device ms of one dense Newton iteration's parts at ``v`` (full
    dofs): assembly of K, its f64 LU, the solve (CUDA events)."""
    sk = prob.steady_kernel(dev)
    vf = torch.as_tensor(np.asarray(v).ravel(), device=dev)
    K = sk.assemble(vf, False)
    lu = torch.linalg.lu_factor(K)
    rhs = torch.cat(sk.rhs(vf, False))[:, None]
    return dict(assembly_ms=time_ms(lambda: sk.assemble(vf, False), 3),
                lu_ms=time_ms(lambda: torch.linalg.lu_factor(K), 3),
                solve_ms=time_ms(lambda: torch.linalg.lu_solve(*lu, rhs), 5),
                n=int(K.shape[0]))


def steady_dense_path(dev):
    """Level-1 DFG 2D-1 through ``solve_steadystate_nse`` on the card
    (``auto``: the dense f64 LU route) against the host-sparse route in
    f64, the published coefficients and a bitwise rerun."""
    prob = dfg_problem(1)
    zero_counts()
    t0 = time.time()
    (v, p), norms = solve_steadystate_nse(prob, **STEADY_KW)
    wall = time.time() - t0
    c = counts()
    npic = 2
    nnwt = len(norms)
    # the right-hand side: one convection vector a Picard iteration, three
    # a Newton iteration; the M-norm of the update one affine M matvec an
    # iteration; the assembly is plain torch, the LU cuSOLVER
    want = dict(vecmat=0, conv_vector=npic + 3 * nnwt,
                conv_vector_amatvec=0, affine_mv=npic + nnwt,
                affine_residual=0,
                elem_mv=0, **NONE_BANDED)
    require(c == want, f"launches of the dense steady run: {c} != {want}")
    require(norms[-1] < 1e-12, f"Newton not converged: {norms}")
    t0 = time.time()
    (vh, ph), nh = solve_steadystate_nse(prob, linsolver="host-sparse",
                                         **STEADY_KW)
    host_s = time.time() - t0
    ev = rel(torch.as_tensor(v), torch.as_tensor(vh))
    ep = rel(torch.as_tensor(p), torch.as_tensor(ph))
    require(ev <= 1e-10 and ep <= 1e-8, f"dense steady vs host-sparse: v "
            f"{ev:.3e}, p {ep:.3e}")
    coef, div = dfg_checked(prob, v, p, "level 1")
    (v2, p2), _ = solve_steadystate_nse(prob, **STEADY_KW)
    require(np.array_equal(v2, v) and np.array_equal(p2, p),
            "two dense steady runs on the card differ")
    parts = dense_step_ms(prob, dev, v)
    say(phase="steady_dense_path",
        problem="DFG 2D-1, cylinderwake level 1, Re 20",
        call="solve_steadystate_nse(prob, return_vp=True, vel_pcrd_stps=2, "
             "vel_nwtn_stps=8, vel_nwtn_tol=1e-12, "
             "return_nwtnupd_norms=True)",
        route="dense (auto)", ncond=len(prob.invinds) + prob.np_cond,
        launches=c, newton_norms=norms, wall_seconds=wall,
        host_sparse_seconds=host_s, rel_err_vs_host_sparse=dict(v=ev, p=ep),
        divergence_max=div, coefficients=coef, published=DFG_REF,
        bitwise_rerun=True, per_iteration=parts)
    return prob, v, p


def fgmres_cycle(prob, dev, v):
    """One restart cycle of the matrix-free route's f32 FGMRES (20 outer
    iterations with the LSC preconditioner) on the Newton system at ``v``
    (full dofs), warmed once; returns the call and its kernel state."""
    sk = SteadyKrylovKernel(prob, device=dev)
    vf = torch.as_tensor(np.asarray(v).ravel(), device=dev)
    elem = _sk_elem32(sk, vf, False)
    r = torch.cat(steady._sk_rhs64(sk, vf, False))
    r = r / torch.linalg.norm(r)

    def run():
        return steady._sk_gmres(sk, elem, r, restart=20, maxiter=1)

    run()
    return run, sk


def check_linv_pair(prob, sk, x):
    """B1 on the matrix-free route's stacked ``(npp, 2 npp)`` operand of
    the (hi, lo) f32 pair of ``L^-1`` (``check_vecmat``), and the summed
    halves of the kernel's output against an f64 sparse solve of
    ``L y = x`` within the same bar (``L = J D_M^-1 J^T``)."""
    require(sk.linv_pair, "level 2 holds L^-1 as the (hi, lo) pair")
    out = check_vecmat(x, sk.LinvT, "L^-1 (hi, lo) pair, the run's "
                       "pressure", 50)
    npp = sk.npp
    y = vecmat(x, sk.LinvT)
    y = (y[:npp] + y[npp:]).double().cpu().numpy()
    Jc = sps.csr_matrix(prob.Jc)
    dM = np.asarray(sps.csr_matrix(prob.Mc).diagonal()).ravel()
    L = (Jc @ sps.diags(1.0 / dM) @ sps.csr_matrix(prob.JTc)).tocsc()[
        :npp, :npp] + 1e-14 * sps.identity(npp, format="csc")
    ref = spla.spsolve(L, x.double().cpu().numpy())
    atol = out["atol"]
    err = np.abs(y - ref)
    require(bool((err <= atol + out["rtol"] * np.abs(ref)).all()),
            f"L^-1 pair: hi + lo off the f64 solve by {err.max():.3e} "
            f"(atol {atol:.3e})")
    out["sum_vs_f64_solve_max_abs_err"] = float(err.max())
    return out


def steady_krylov_level2(dev):
    """Level-2 DFG 2D-1 through the same call (``auto``: the matrix-free
    route) against the host-sparse route in f64 and the card's dense f64
    LU route, the published coefficients and the divergence; B10
    launches equal to the F-matvecs the solver reports; B1 on the route's
    ``L^-1`` pair and B5 on its f64 tables, under the run's state."""
    prob = dfg_problem(2)
    ncond = len(prob.invinds) + prob.np_cond
    require(ncond > 25000, "level 2 is past the dense ceiling")
    stats = {}
    zero_counts()
    t0 = time.time()
    (v, p), norms = solve_steadystate_nse(prob, stats=stats, **STEADY_KW)
    torch.cuda.synchronize()
    wall = time.time() - t0
    c = counts()
    require(c["elem_mv"] == stats["n_fmv"] > 0,
            f"elem_mv launches {c['elem_mv']} != the solver's F-matvecs "
            f"{stats['n_fmv']}")
    require(c["vecmat"] > 0 and c["affine_mv"] > 0 and c["conv_vector"] > 0,
            f"the matrix-free route's kernels: {c}")
    # an F-matvec is one elem_mv launch: the affine stiffness ('a') runs
    # only in the f64 residuals, one a refinement round and one to stop
    residuals = sum(s["rounds"] + 1 for s in stats["solves"]
                    if s["rounds"] or s["rel_res"] > 0.0)
    modes = dict(affine_mv.mode_launches)
    require(modes["a"] == residuals, f"affine 'a' launches {modes['a']} != "
            f"the {residuals} f64 residuals (an F-matvec launched A v)")
    require(norms[-1] < 1e-12, f"Newton not converged: {norms}")
    coef, div = dfg_checked(prob, v, p, "level 2")
    # one FGMRES restart cycle (20 outer iterations, the unit a solve
    # repeats: 3 a refinement round) under the profiler, at the solution
    cycle, sk = fgmres_cycle(prob, dev, v)
    busy, nkern, cycle_wall = busy_share(cycle)
    # the route's own operands: L^-1 under the run's pressure, the f64
    # convection tables under the run's velocity and the boundary data
    linv = check_linv_pair(prob, sk, torch.as_tensor(
        p.ravel(), device=dev, dtype=torch.float32))
    aff = AffineVectorOps.build(prob, torch.float64, full_dofs=True,
                                device=dev)
    conv = check_conv(prob.conv_kernel_on(torch.float64), aff,
                      aff.fac_dofs, torch.as_tensor(v.ravel(), device=dev),
                      sk.v_bc64, "level 2, the run's velocity",
                      bool(prob.gradvsymmtrc), False)
    del sk, aff, cycle
    # the host-sparse route in f64: the oracle that shares no kernel
    t0 = time.time()
    (vh, ph), nh = solve_steadystate_nse(prob, linsolver="host-sparse",
                                         **STEADY_KW)
    host_s = time.time() - t0
    eh = dict(v=rel(torch.as_tensor(v), torch.as_tensor(vh)),
              p=rel(torch.as_tensor(p), torch.as_tensor(ph)))
    require(eh["v"] <= 1e-8 and eh["p"] <= 1e-6, f"matrix-free vs "
            f"host-sparse at level 2: {eh}")
    # the card's dense route at level 2: the F13 reading, and a second
    # oracle
    t0 = time.time()
    (vd, pd), nd = solve_steadystate_nse(prob, linsolver="dense",
                                         **STEADY_KW)
    dense_s = time.time() - t0
    ev = rel(torch.as_tensor(v), torch.as_tensor(vd))
    ep = rel(torch.as_tensor(p), torch.as_tensor(pd))
    require(ev <= 1e-8 and ep <= 1e-6, f"matrix-free vs dense at level 2: "
            f"v {ev:.3e}, p {ep:.3e}")
    parts = dense_step_ms(prob, dev, vd)
    solves = stats["solves"]
    outer = [s["rounds"] * 3 * 20 for s in solves]
    say(phase="steady_krylov_level2",
        problem="DFG 2D-1, cylinderwake level 2, Re 20", ncond=ncond,
        route="krylov (auto)", launches=c, affine_modes=modes,
        f64_residuals=residuals, newton_norms=norms,
        wall_seconds=wall, coefficients=coef, published=DFG_REF,
        divergence_max=div, f_iters=stats["f_iters"],
        f_cycles=stats["f_cycles"], f_matvecs=stats["n_fmv"],
        solves=solves, fgmres_outer_iterations_per_solve=outer,
        one_fgmres_cycle=dict(wall_seconds=cycle_wall, device_busy_ms=busy,
                              device_kernels=nkern,
                              busy_share=(None if busy is None
                                          else 1e-3 * busy / cycle_wall)),
        vecmat_linv_pair=linv, convection_f64_level2=conv,
        host_sparse_route=dict(seconds=host_s, newton_norms=nh),
        rel_err_vs_host_sparse=eh,
        dense_route=dict(seconds=dense_s, newton_norms=nd,
                         per_iteration=parts),
        rel_err_vs_dense=dict(v=ev, p=ep))
    return c["elem_mv"]


def krylov_cnab(prob, kw, ref, nsteps):
    """``cnab`` on the Krylov saddle solver at level 1 (Re 100, 300 steps)
    against the CPU f64 dense run; the solver's true-residual telemetry
    over repeated increment-sized solves."""
    zero_counts()
    t0 = time.time()
    o = solve_nse(prob=prob, **dict(kw, linsolver="krylov"))
    torch.cuda.synchronize()
    wall = time.time() - t0
    c = counts()
    require(isinstance(o["ops"].solver, KrylovSaddleSolver)
            and o["ffflag"] is False, "Krylov cnab run")
    require(c["vecmat"] > 0 and c["affine_mv"] > 0
            and c["elem_mv"] == 0, f"launches of the Krylov run: {c}")
    e = rel(o["v"], ref["v"])
    require(e <= 1e-4, f"Krylov cnab vs CPU f64: {e:.3e}")
    slv = o["ops"].solver
    # B1 on the solver's S^-1 under the run's pressure
    sinv = check_vecmat(o["p"].to(slv.dtype).contiguous(), slv.SinvT,
                        "S^-1 of the Krylov solver, the run's pressure", 50)
    rhs0 = o["ops"].dt * torch.as_tensor(
        np.asarray(prob.fv).ravel(), device=slv.device, dtype=slv.dtype)
    zp = torch.zeros(slv.np, device=slv.device, dtype=slv.dtype)
    res = torch.stack([slv.solve_res(rhs0 * (1.0 + 1e-3 * k), zp)[1]
                       for k in range(8)]).cpu().tolist()
    say(phase="krylov_cnab", problem="cylinderwake level 1, Re 100",
        steps=nsteps, launches=c, wall_seconds=wall,
        loop_seconds=o["timing"]["loop_s"],
        ms_per_step=1e3 * o["timing"]["loop_s"] / nsteps,
        vecmat_per_step=c["vecmat"] / nsteps, vecmat_sinv=sinv,
        tol=slv.tol,
        rel_err_v_vs_cpu_f64=e, bar=1e-4, solve_res_telemetry=res)


def pseudotime_path(prob, v_newton):
    """``solve_steadystate_pseudotime`` at level 1, Re 20, on the card
    against the dense route's Newton solution (the JAX test's bar)."""
    zero_counts()
    t0 = time.time()
    vpt, info = solve_steadystate_pseudotime(
        prob, tol=2e-7, chunk=400, max_rounds=40, verbose=False,
        return_info=True)
    wall = time.time() - t0
    c = counts()
    e = rel(torch.as_tensor(vpt), torch.as_tensor(v_newton))
    require(info["converged"] and e <= 5e-5,
            f"pseudo-time vs Newton: {e:.3e}, {info['rounds']} rounds")
    say(phase="pseudotime_path", problem="DFG 2D-1, level 1, Re 20",
        rounds=info["rounds"], dt=info["dt"], rates=info["rates"],
        wall_seconds=wall, launches=c, rel_err_vs_newton=e, bar=5e-5)


# ---------------------------------------------------------------------------
# the banded convection tail (B6) and Newton-in-time
# ---------------------------------------------------------------------------

TAIL_REPLACES = "dolfin_navier_scipy_tpu/ops/banded_conv.py:154"
# sha256 prefixes (tools_torch/seeded_inputs.py: digest) of the tail's
# vector by level, on the default call's w-space kernel and the seeded
# state tail_state(vbc, nin, level): read on an H100 80GB HBM3 (700.00 W)
# from commit 292ccd0's three-launch tail (int8 G and S through bandmv.cu,
# the quadrature kernel between them), ``tail_vecmat_t.py --root``.  The
# one-launch kernel must give the same bits.
TAIL_BITS = {1: "c137b654ac7cec23", 2: "82b1e63a50d56902"}
# the same for vecmat_t on seeded_operand(m, n, seed 1) under seeded(n, 2)
# in f32, commit 292ccd0's kernel
VECMAT_T_BITS = {(8794, 8794): "06da4bf475183140",
                 (31061, 31061): "bac9e3c109126eb5"}


def tail_bound_ms(t, nin, u_itemsize=8):
    """Least time for one tail vector: the sorted element ids, the state's
    interior, ``ue_bc`` and the geometry and reference tables read once,
    the element loads written and read once, the output written once, over
    the memory rate; the quadrature's multiply-adds (the element chain's
    fields, gradient and loads, as ``conv_bound_ms`` counts them) and the
    row sums' adds over the f32 rate."""
    nc, nd, Q, dim, nvpc = t.nc, t.nd, t.Q, t.dim, t.nvpc
    nbytes = (4 * nc * nd + u_itemsize * nin + 4 * nc * nd
              + 4 * nc * (dim * dim + Q) + 4 * Q * nvpc * (1 + dim)
              + 2 * 4 * nc * nd + 4 * nin)
    per_q = (2 * nvpc * dim + 2 * nvpc * dim * dim + 2 * dim ** 3
             + 2 * dim * dim + dim + 2 * nvpc * dim)
    flops = nc * Q * per_q + 2 * nc * nd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def abs_chain(t):
    """The tables with every factor of the quadrature chain made positive:
    ``conv_quad_ref`` on them (and on |ue|, |ue_bc|) is each element
    value's sum of absolute products."""
    ta = copy.copy(t)
    ta.JinvT, ta.wdet = t.JinvT.abs(), t.wdet.abs()
    ta._plain = tuple(w.abs() for w in t.plain_weights())
    return ta


def tail_library(tail, v, gen):
    """The tail's two 0/1 products, each as one PyTorch call on inputs
    made beforehand, held to the plain version and timed (graph replay):
    G as one ``index_select`` of the state (cast to f32, a zero appended
    for the bc entries), S as one cuSPARSE CSR matvec over seeded f32
    element loads.  No one call computes the whole tail."""
    dev, nin, nvals = v.device, tail.nin, tail.nvals
    rows = tail.kern.vd.reshape(-1).to(torch.int64)
    keep = rows < nin
    gidx = torch.where(keep, rows, torch.full_like(rows, nin))
    v_pad = torch.cat([v[:nin].float(), v.new_zeros(1, dtype=torch.float32)])
    g = torch.index_select(v_pad, 0, gidx)
    require(torch.equal(g, kernels._tail_gather(v, tail.kern.tables, nin)),
            "the library form of G is not the tail's gather")
    S_csr = torch.sparse_coo_tensor(
        torch.stack([rows[keep], torch.arange(nvals, device=dev)[keep]]),
        torch.ones(int(keep.sum()), device=dev), (nin, nvals)
    ).coalesce().to_sparse_csr()
    fe = torch.randn(nvals, generator=gen, dtype=torch.float32).to(dev)
    ref = tail_sum_ref(fe, tail.slots)
    err = float((S_csr @ fe - ref).abs().max())
    require(err <= 1e-6 * float(ref.abs().max()),
            f"the library form of S is not its product: {err}")
    return dict(
        G=library_times(lambda: torch.index_select(v_pad, 0, gidx)),
        S=library_times(lambda: S_csr @ fe),
        library=("torch.index_select of the f32 state (G) + cuSPARSE CSR "
                 "matvec of the f32 0/1 S (torch sparse CSR @), inputs "
                 "made beforehand"))


def check_tail(tail, kern, vbc, level, gen):
    """The one-launch tail (``conv_tail``) at one level: against its plain
    version on a seeded w-space state within 1e-5 of each row's sum of
    absolute products, the same bits twice, one kernel node a call, the
    bits of the three-launch tail on ``tail_state`` (``TAIL_BITS``), and
    against B5 on the same state (1e-5 of max|B5|, bc rows zero); timed
    (graph replay) beside its bound, B5's vector and the library calls of
    its two products."""
    nin, t, slots = tail.nin, tail.kern.tables, tail.slots
    dev = tail.ue_bc.device
    v = torch.from_numpy(vbc.copy()).to(dev)
    v[:nin] = torch.randn(nin, generator=gen, dtype=torch.float64).to(dev)
    zero_counts()
    y = tail.vector(v).clone()
    torch.cuda.synchronize()
    require(conv_tail.launches == 1 and sum(counts().values()) == 0,
            f"one tail vector: one conv_tail launch, got {conv_tail.launches}"
            f" and {counts()}")
    again = tail.vector(v).clone()
    ref = conv_tail_ref(v, tail.ue_bc, t, slots)
    gat = kernels._tail_gather(v, t, nin)
    bar = 1e-5 * tail_sum_ref(conv_quad_ref(gat.abs(), tail.ue_bc.abs(),
                                            abs_chain(t)), slots) + 1e-30
    err = (y[:nin] - ref).abs()
    require(bool(torch.isfinite(y).all()) and y.dtype == torch.float32,
            "tail vector type or finiteness")
    require(bool((err <= bar).all()), f"level {level}: conv_tail disagrees "
            f"with its plain version: worst ratio to the row bar "
            f"{float((err / bar).max()):.3e}")
    require(torch.equal(y, again), "conv_tail is not reproducible")
    require(not bool(y[nin:].any()), "the tail's bc rows are not zero")
    b5 = kern.vector(v)
    b5_err = float((y[:nin] - b5[:nin].float()).abs().max())
    scale = float(b5.abs().max())
    require(b5_err <= 1e-5 * scale, f"level {level}: tail vs B5 "
            f"{b5_err:.3e} > 1e-5 of {scale:.3e}")
    ran, types = device_kernels(lambda: tail.vector(v))
    require(ran == 1, f"one tail vector ran {ran} device kernels ({types})")
    vb = tail_state(vbc, nin, level, dev)
    bits = digest(tail.vector(vb))
    require(bits == TAIL_BITS[level], f"level {level}: the tail's bits "
            f"{bits} are not the three-launch tail's {TAIL_BITS[level]}")
    bound, by = tail_bound_ms(t, nin)
    lib = tail_library(tail, v, gen)
    out = dict(name="conv_tail", level=level, nc=t.nc, nin=nin,
               nvals=tail.nvals, slot_width=int(slots.shape[0]),
               table_bytes=tail.nbytes, bits=bits,
               max_abs_err=float(err.max()),
               max_err_over_row_bar=float((err / bar).max()),
               tail_vs_b5_max_abs_err=b5_err, b5_max_abs=scale,
               device_kernels_per_call=ran,
               ms=graph_ms(lambda: tail.vector(v)),
               eager_ms=time_ms(lambda: tail.vector(v), 200),
               plain_ms=time_ms(lambda: conv_tail_ref(v, tail.ue_bc, t,
                                                      slots), 20),
               b5_ms=graph_ms(lambda: kern.vector(v)),
               b5_bound_ms=conv_bound_ms(kern.tables, 8, False, False, 0)[0],
               library_ms=None,
               library_parts_ms=dict(G=lib["G"]["library_ms"],
                                     S=lib["S"]["library_ms"]),
               library_parts_eager_ms=dict(
                   G=lib["G"]["library_eager_ms"],
                   S=lib["S"]["library_eager_ms"]),
               library=lib["library"], bound_ms=bound, bound_by=by)
    out["library_sum_ms"] = sum(out["library_parts_ms"].values())
    out["roofline_share"] = bound / out["ms"]
    out["over_b5"] = out["ms"] / out["b5_ms"]
    return out


def banded_conv_path(dev, gen, nsteps, ref):
    """The banded convection tail (B6) at levels 1 and 2 on the default
    call's own w-space kernel and bc tail, built with ``force``: the slot
    form (no band on the card), ``check_tail``, the measured cost per 1000
    element values of the tail and of B5, and the gate's decision under
    the card's constants.  Then, at level 1, the default call with
    ``banded_conv=True`` (``warm_refine`` 0 and 1) against the CPU f64 run
    ``ref`` at the default call's bars, with its exact launches.  Returns
    ``(the tail's checks by level, launches of the forced run)``."""
    checks = {}
    dt = (TE - T0) / NTS
    for level in (LEVEL, LEVEL2):
        prob = cylinderwake_problem(level=level, Re=RE, charvel=CHARVEL)
        kern, nin, vbc = wspace_kernel(prob, dt, dev)
        t0 = time.time()
        tail = build_banded_conv_tail(kern, nin, vbc[nin:], force=True)
        build_s = time.time() - t0
        require(tail.slots is not None and tail.Sb is None
                and tail.Gb is None, "the card's tail holds no band")
        chk = check_tail(tail, kern, vbc, level, gen)
        consts = gate_constants(dev)
        measured = dict(
            tail_us_per_1k_vals=1e3 * chk["ms"] / (tail.nvals / 1000.0),
            b5_us_per_1k_vals=1e3 * chk["b5_ms"] / (tail.nvals / 1000.0))
        wins = banded_wins(tail.nbytes, nvals=tail.nvals, consts=consts)
        gated = build_banded_conv_tail(kern, nin, vbc[nin:])
        require((gated is not None) == (wins and tail.nbytes
                                         <= consts["max_gb"] * 1e9),
                "the gate's decision")
        chk.update(build_seconds=build_s, windows=dict(
            wS=tail.windows[1], wG=tail.windows[4]), measured=measured,
            gate=dict(constants=consts,
                      tail_us=tail_us(tail.nbytes, consts, nvals=tail.nvals),
                      index_pipeline_us=index_pipeline_us(
                          consts["index_us_per_1k_vals"], nvals=tail.nvals),
                      banded_wins=wins, builds=gated is not None))
        checks[level] = chk
        say(phase="banded_conv_level", **chk)
        del tail, gated, kern
        torch.cuda.empty_cache()

    # the default call at level 1 with the tail forced
    prob = cylinderwake_problem(level=LEVEL, Re=RE, charvel=CHARVEL)
    dkw = dict(t0=T0, tE=TE, Nts=NTS, start_ssstokes=True,
               save_every=SAVE_EVERY)
    runs = {}
    for wr in (0, 1):
        zero_counts()
        o = solve_nse(prob=prob, warm_refine=wr, banded_conv=True, **dkw)
        torch.cuda.synchronize()
        c = dict(counts(), conv_tail=conv_tail.launches)
        # a loop step: the tail (one launch), the banded A, the solve (W, J,
        # S^-1, X) and per refine round the residual (F, J^T, J) and a
        # second solve; the start: 3 Heun bootstrap vectors and the AB2
        # start value through B5
        want = dict(vecmat=0, conv_vector=4, conv_vector_amatvec=0,
                    banded_mv=nsteps * (1 + wr),
                    rect_mv=nsteps * (1 + 3 * wr),
                    rect_mv_levels=nsteps * 3 * (1 + wr), affine_mv=0,
                    affine_residual=0, elem_mv=0, conv_tail=nsteps)
        require(c == want, f"launches of the forced-tail run, warm_refine="
                f"{wr}: {c} != {want}")
        require(o["bct"] is not None and o["ffflag"] is False, "tail run")
        e = {k: rel(o[k], ref[k]) for k in ("v", "p", "vs", "ps")}
        bar = 1e-6 if wr else 1e-4
        require(e["v"] <= bar and e["vs"] <= bar,
                f"forced-tail run, warm_refine={wr}, card vs CPU f64: {e}")
        div = divergence_rel(prob, o["v"])
        require(div <= 1e-6, f"forced-tail run: divergence {div:.3e}")
        t = o["timing"]
        runs[wr] = dict(launches=c,
                        launches_per_step={k: v / nsteps
                                           for k, v in c.items()},
                        loop_seconds=t["loop_s"],
                        ms_per_step=1e3 * t["loop_s"] / nsteps,
                        rel_err_vs_cpu_f64=e, bar=bar,
                        divergence_residual_rel=div)
        if wr == 0:
            forced = c
        del o
    say(phase="banded_conv_path", call="solve_nse(prob, t0, tE, Nts=300, "
        "start_ssstokes=True, save_every=60, warm_refine=0|1, "
        "banded_conv=True)", problem="cylinderwake level 1, Re 100",
        steps=nsteps, runs=runs, oracle="the main path's CPU f64 run")
    return checks, forced


def newton_counts(st, nts, npic, per_precond=None, pfromv=1):
    """The launches of a Newton-in-time run from its sweep counts: per
    sweep the convection data at every time point (one B5 vector a point
    in a Picard sweep, three in a Newton sweep), an element-matrix matvec
    (B10) and a fused residual (B9) a system matvec, one more B10 a step
    (the rhs) and B9's ``ma`` a step (E v) and ``m`` a time point (the
    M-norm); a preconditioner application is one ``vecmat`` (B1, the
    dense inverse) or ``per_precond`` (the Schur solver's launches a
    solve).  ``pfromv``: B5 vectors of ``solve_nse``'s initial pressure
    (``get_pfromv``, one where ``inip`` is not given)."""
    sw, mv, pc = st["sweeps"], st["matvecs"], st["preconds"]
    nn = sw - npic
    want = dict(vecmat=pc if per_precond is None else 0,
                conv_vector=(nts + 1) * (npic + 3 * nn) + pfromv,
                conv_vector_amatvec=0, affine_mv=sw * (2 * nts + 1),
                affine_residual=mv, elem_mv=mv + nts * sw, **NONE_BANDED)
    for k, n in (per_precond or {}).items():
        want[k] += n * pc
    return want


def newton_ti_path(dev, dfg1, v_newton):
    """Newton-in-time through ``solve_nse(treat_nonl_explicit=False)`` (and
    ``solve_nse_newton_ti`` for a control), at full width:

    * level 2, Re 100 (the JAX package's heavy configuration): dt 2.5e-4,
      16 steps from the host Stokes solve of ``[[M + dt/2 A, J^T],[J,
      0]]``, 2 Picard + 5 Newton sweeps, tol 1e-11, ``linsolver='auto'``:
      the block-Schur solver preconditions (no ``vecmat`` launch); against
      the card's default CNAB run (rel < 1e-2); the norms fall strictly and
      the last is < 1e-6;
    * level 1, DFG 2D-1 (Re 20), ``linsolver='dense'`` (B1 on the 8016^2
      inverse), from the card's steady solution: drift < 1e-8 relative,
      last norm < 1e-8, a bitwise rerun, one sweep's wall and busy share;
    * level 1, the rotating cylinder (``sin(20 t)``), dense, from the
      steady state at Re 40: against the card's controlled CNAB (< 2e-4);

    each with its exact launches from the sweep counts."""
    rows = {}
    # (a) level 2, the Schur solver as the preconditioner
    prob = cylinderwake_problem(level=LEVEL2, nu=1e-3, charvel=1.0)
    dt = 2.5e-4
    vp = solve_sadpnt_host(amat=prob.Mc + 0.5 * dt * prob.Ac, jmat=prob.Jc,
                           jmatT=prob.JTc, rhsv=np.asarray(prob.fv).ravel(),
                           rhsp=np.asarray(prob.fp).ravel())
    v0 = vp[: len(prob.invinds), 0]
    trange = np.linspace(0.0, 16 * dt, 17)
    se = solve_nse(prob=prob, trange=trange, iniv=v0, save_every=None)
    ops = _build_ops(prob, dt, theta=0.5, device=dev)
    require(isinstance(ops.solver, SchurSaddleSolver), "level 2: 'auto' is "
            "the block-Schur solver")
    zero_counts()
    ops.solver.solve(torch.zeros(len(v0), dtype=torch.float32, device=dev),
                     torch.ones(prob.np_cond, dtype=torch.float32,
                                device=dev))
    per_solve = {k: n for k, n in counts().items() if n}
    del ops
    zero_counts()
    t0 = time.time()
    ti = solve_nse(prob=prob, trange=trange, iniv=v0,
                   treat_nonl_explicit=False, vel_nwtn_stps=5,
                   vel_nwtn_tol=1e-11, save_every=None)
    torch.cuda.synchronize()
    wall = time.time() - t0
    c = counts()
    st = ti["stats"]
    want = newton_counts(st, 16, 2, per_solve)
    nrm = ti["nwtn_norms"]
    e = rel(ti["v"], se["v"])
    rows["level2_schur"] = dict(
        problem="cylinderwake level 2, Re 100 (nu 1e-3, charvel 1)",
        nin=len(prob.invinds), np=prob.np_cond, steps=16, dt=dt,
        nwtn_norms=nrm, stats=st, launches=c, schur_solve_launches=per_solve,
        wall_seconds=wall, rel_vs_cnab=e, bar=1e-2)
    say(phase="newton_ti_run", **rows["level2_schur"])
    require(c == want, f"level 2 Newton-in-time launches: {c} != {want}")
    require(e < 1e-2, f"level 2 Newton-in-time vs CNAB: {e:.3e}")
    require(all(b < a for a, b in zip(nrm, nrm[1:])) and nrm[-1] < 1e-6,
            f"level 2 Newton norms: {nrm}")
    del prob, se, ti
    torch.cuda.empty_cache()

    # (b) level 1, DFG 2D-1 from the card's steady solution, dense
    nin = len(dfg1.invinds)
    vss = np.asarray(v_newton).ravel()[dfg1.invinds]
    kw = dict(trange=np.linspace(0.0, 0.01, 11), iniv=vss,
              treat_nonl_explicit=False, vel_pcrd_stps=0, vel_nwtn_stps=3,
              vel_nwtn_tol=1e-12, save_every=None, linsolver="dense")
    zero_counts()
    t0 = time.time()
    d1 = solve_nse(prob=dfg1, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    c = counts()
    want = newton_counts(d1["stats"], 10, 0)
    drift = float(np.linalg.norm(d1["v"].cpu().numpy() - vss)
                  / np.linalg.norm(vss))
    say(phase="newton_ti_run", problem="DFG 2D-1 level 1", launches=c,
        stats=d1["stats"], nwtn_norms=d1["nwtn_norms"], drift_rel=drift,
        wall_seconds=wall)
    require(c == want, f"DFG Newton-in-time launches: {c} != {want}")
    require(drift < 1e-8 and d1["nwtn_norms"][-1] < 1e-8,
            f"DFG steady state drifted {drift:.3e}: {d1['nwtn_norms']}")
    again = solve_nse(prob=dfg1, **kw)
    require(torch.equal(again["v_traj"], d1["v_traj"]),
            "two Newton-in-time runs on the card differ")
    # one sweep on a bundle built beforehand: its wall and device-busy share
    b = _make_bundle(dfg1, 1e-3, linsolver="dense", device=dev)
    lin, ini = d1["v_traj"], d1["v_traj"][0]
    _sweep(b, lin, ini, None, None)
    busy, kerns, sweep_wall = busy_share(
        lambda: _sweep(b, lin, ini, None, None))
    del b
    rows["level1_dfg_dense"] = dict(
        problem="DFG 2D-1, cylinderwake level 1, Re 20", nin=nin,
        ncond=nin + dfg1.np_cond, steps=10, nwtn_norms=d1["nwtn_norms"],
        stats=d1["stats"], launches=c, wall_seconds=wall, drift_rel=drift,
        bitwise_rerun=True, one_sweep=dict(
            wall_seconds=sweep_wall, device_busy_ms=busy,
            device_kernels=kerns,
            busy_share=None if busy is None else busy / (1e3 * sweep_wall)))
    del d1, again, lin, ini

    # (c) level 1, the rotating cylinder, dense, from the steady state
    rot = cylinderwake_problem(level=LEVEL, Re=40, charvel=CHARVEL,
                               movingwallcntrl=True)
    vr = solve_steadystate_nse(rot, vel_pcrd_stps=2, vel_nwtn_stps=5,
                               vel_nwtn_tol=1e-10)
    v0 = np.asarray(vr).ravel()[rot.invinds]
    trange = np.linspace(0.0, 0.02, 41)
    se = solve_nse(prob=rot, trange=trange, iniv=v0, save_every=None,
                   controls=rot_control(rot, dev))
    zero_counts()
    t0 = time.time()
    ti = solve_nse_newton_ti(prob=rot, trange=trange, iniv=v0,
                             inip=np.zeros(rot.np_cond),
                             controls=rot_control(rot, dev),
                             vel_nwtn_stps=4, vel_nwtn_tol=1e-12,
                             save_every=None, linsolver="dense")
    torch.cuda.synchronize()
    wall = time.time() - t0
    c = counts()
    want = newton_counts(ti["stats"], 40, 0, pfromv=0)
    e = rel(ti["v"], se["v"])
    say(phase="newton_ti_run", problem="rotating cylinder level 1",
        launches=c, stats=ti["stats"], nwtn_norms=ti["nwtn_norms"],
        rel_vs_cnab=e, wall_seconds=wall)
    require(c == want, f"controlled Newton-in-time launches: {c} != {want}")
    require(e < 2e-4, f"controlled Newton-in-time vs CNAB: {e:.3e}")
    moved = rel(ti["v"], torch.as_tensor(v0))
    rows["level1_rotcyl_dense"] = dict(
        problem="cylinderwake level 1, Re 40, movingwallcntrl, sin(20 t)",
        steps=40, nwtn_norms=ti["nwtn_norms"], stats=ti["stats"],
        launches=c, wall_seconds=wall, rel_vs_cnab=e, bar=2e-4,
        rel_moved_from_start=moved)
    say(phase="newton_ti_path", **rows)
    return rows


# -- the discrete adjoint (make_diff_cnab) and its backward kernels --------

# examples/adjoint_control_gradient.py: the DFG wake at Re 40 (charvel 0.2),
# dt 2.5e-4, 40 CNAB steps from the steady state, forced by a body-force
# blob behind the cylinder; the schedule recovered from the terminal field
ADJ_RE, ADJ_DT, ADJ_STEPS = 40.0, 2.5e-4, 40
ADJ_REPLACES = dict(
    # jax.grad transposes the XLA dot of the inverse apply and the element
    # pipeline of B5: no TPU kernel of their own; the forward kernels'
    vecmat_t="dolfin_navier_scipy_tpu/ops/pallas_kernels.py:31",
    conv_vjp="tools/probe_pallas_gather.py:14")


def adjoint_counts(n, kind):
    """Launches of one derivative of ``n`` steps of ``make_diff_cnab``
    (remat on), derived in ``tests/test_torch_adjoint.py`` and the port's
    CPU count: the forward loop (one B5 fused, one B1 a step, one B5 vector
    for the AB2 start), remat's recomputation of each step, and one
    backward of B1 and of B5 a step ('amps': B5's not at the first step,
    whose state does not depend on the schedule; 'v0': also the start
    value's); forward mode ('jvp') takes the forward kernels only: B1
    once more a step, B5 vector twice a step and twice for the start."""
    if kind == "jvp":
        return dict(vecmat=2 * n, conv_vector=3 + 2 * n,
                    conv_vector_amatvec=2 * n, vecmat_t=0, conv_vjp=0)
    return dict(vecmat=2 * n, conv_vector=1, conv_vector_amatvec=2 * n,
                vecmat_t=n, conv_vjp=n - 1 if kind == "amps" else n + 1)


def adj_counts():
    return dict(vecmat=vecmat.launches, conv_vector=conv_vector.launches,
                conv_vector_amatvec=conv_vector_amatvec.launches,
                vecmat_t=vecmat_t.launches, conv_vjp=conv_vjp.launches)


def vecmat_t_bits(m, n, dev):
    """``vecmat_t`` on the seeded ``(m, n)`` f32 operand of
    ``VECMAT_T_BITS``: its digest, held to the record."""
    KT = seeded_operand(kernels, m, n, 1, dev)
    bits = digest(vecmat_t(seeded(n, 2, dev, torch.float32), KT))
    require(bits == VECMAT_T_BITS[(m, n)], f"vecmat_t's bits at {(m, n)} "
            f"{bits} are not the first kernel's {VECMAT_T_BITS[(m, n)]}")
    del KT
    torch.cuda.empty_cache()
    return bits


def check_vecmat_t(g, KT, what, reps):
    """``vecmat_t`` against its plain version on the same inputs (the bar
    of :func:`check_vecmat`), one device kernel a call, the bits of the
    first kernel on a seeded operand of the same shape
    (``VECMAT_T_BITS``), the grid it launches beside the blocks resident at
    once, then the timings (the library call: ``torch.mv(KT, g)``)."""
    m, n = KT.shape
    y = vecmat_t(g, KT)
    torch.cuda.synchronize()
    ref = vecmat_t_ref(g, KT)
    atol = 1e-5 * float(torch.linalg.vector_norm(g)) * float(KT.abs().max())
    rtol = 1e-4
    err = (y - ref).abs()
    require(bool((err <= atol + rtol * ref.abs()).all()),
            f"vecmat_t kernel disagrees with vecmat_t_ref at {what} "
            f"{(m, n)}: max abs err {float(err.max()):.3e}")
    require(torch.equal(y, vecmat_t(g, KT)),
            "vecmat_t kernel is not reproducible run to run")
    ran, types = device_kernels(lambda: vecmat_t(g, KT))
    require(ran == 1, f"vecmat_t ran {ran} device kernels ({types})")
    bits = vecmat_t_bits(m, n, KT.device)
    blocks, resident = vecmat_t_grid(m, KT.dtype)
    bound, by = vecmat_bound_ms(m, n, KT.element_size())
    out = dict(shape=[m, n], operand=what, dtype=str(KT.dtype),
               bits=bits, grid_blocks=blocks, resident_blocks=resident,
               ld=KT.stride(0), max_abs_err=float(err.max()), atol=atol,
               rtol=rtol, device_kernels_per_call=ran,
               ms=graph_ms(lambda: vecmat_t(g, KT)),
               eager_ms=time_ms(lambda: vecmat_t(g, KT), reps),
               plain_ms=time_ms(lambda: vecmat_t_ref(g, KT), reps),
               **library_times(lambda: torch.mv(KT, g), reps),
               library="torch.mv(KT, g)", bound_ms=bound, bound_by=by)
    out["roofline_share"] = bound / out["ms"]
    return out


def conv_vjp_bound_ms(t, u_itemsize, nfac):
    """Least time for one ``conv_vjp`` call: the state and both
    cotangents read once, the result written once, the tables and facet
    blocks read once, over the memory rate; the element chain's
    multiply-adds (the state's fields, the cotangent at the point, the two
    terms of each element dof, the stiffness chain on the second
    cotangent), the facet blocks and the reduction over the work type's
    rate."""
    s = t.wdet.element_size()
    nc, nd, Q, dim, nvpc = t.nc, t.nd, t.Q, t.dim, t.nvpc
    nbytes = (u_itemsize * t.nv_full * 4 + 4 * nc * nd
              + s * nc * (dim * dim + Q) + s * Q * nvpc * (1 + dim)
              + nfac * nd * (s * nd + 4))
    fields = 2 * nvpc * dim + 2 * nvpc * dim * dim + 2 * dim ** 3
    per_q = (fields + 2 * nvpc * dim + dim + 2 * dim * dim
             + nvpc * (2 * dim * dim + 2 * dim + 3 * dim)
             + fields + 3 * dim ** 3 + dim * dim + 2 * nvpc * dim * dim + nd)
    flops = nc * Q * per_q + 2 * nfac * nd * nd + nc * nd + nfac * nd
    rate = F32_FLOP_PER_S if s == 4 else F64_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_conv_vjp(kern, aff, u, gen, what, timed):
    """``conv_vjp`` against its plain version (``torch.func.vjp`` of the
    plain forward) on the same inputs, with :func:`check_conv`'s bar: the
    fused form with both cotangents and the facet blocks (``sym`` both
    ways) and the vector form; two launches give the same bits, one device
    kernel a call; ``timed``: the timings of the fused form (the plain
    version eager: a functional transform is not captured)."""
    t = kern.tables
    most = t.kernel_tables()[1].shape[0]
    eps = max(torch.finfo(t.dtype).eps, torch.finfo(u.dtype).eps)
    nv = t.nv_full
    gc, ga = (torch.randn(nv, generator=gen, dtype=torch.float64)
              .to(device=u.device, dtype=u.dtype) for _ in range(2))
    fe, fv, nfac = aff.fac_elem, aff.fac_dofs, int(aff.fac_elem.shape[0])
    forms = [(f"fused_sym_{sym}",
              lambda sym=sym: conv_vjp(u, gc, ga, aff.nu, sym, t, fe, fv),
              lambda sym=sym: conv_vjp_ref(u, gc, ga, aff.nu, sym, t, fe,
                                           fv))
             for sym in (True, False)]
    forms.append(("vector", lambda: conv_vjp(u, gc, None, 0.0, False, t),
                  lambda: conv_vjp_ref(u, gc, None, 0.0, False, t)))
    rows = []
    for name, run, plain in forms:
        got, ref, again = run(), plain(), run()
        torch.cuda.synchronize()
        atol = 50 * eps * float(ref.abs().max()) * most
        err = float((got - ref).abs().max())
        require(got.dtype == u.dtype and got.shape == ref.shape,
                "conv_vjp output type")
        require(err <= atol, f"conv_vjp kernel ({name}, {what}) disagrees "
                f"with its plain version: {err:.3e} > {atol:.3e}")
        require(torch.equal(got, again), f"conv_vjp kernel ({name}) is not "
                "reproducible launch to launch")
        bound, by = conv_vjp_bound_ms(t, u.element_size(),
                                      nfac if name != "vector" else 0)
        row = dict(form=name, operand=what, tables=str(t.dtype),
                   state=str(u.dtype), nc=t.nc, nv_full=nv,
                   facet_blocks=nfac if name != "vector" else 0,
                   max_abs_err=err, atol=atol, bound_ms=bound, bound_by=by,
                   library_ms=None)
        if timed and name == "fused_sym_True":
            ran, types = device_kernels(run)
            require(ran == 1, f"conv_vjp ran {ran} device kernels "
                    f"({types})")
            row.update(device_kernels_per_call=ran, ms=graph_ms(run),
                       eager_ms=time_ms(run, 200),
                       plain_ms=time_ms(plain, 20))
        rows.append(row)
    return rows


def steady_inner(prob, only_stokes=False):
    """The steady state (or the Stokes solution) of ``prob`` on the host
    (scipy splu), as inner dofs."""
    return np.asarray(solve_steadystate_nse(
        prob, linsolver="host-sparse", vel_nwtn_tol=1e-11, verbose=False,
        only_stokes=only_stokes)).ravel()[prob.invinds]


def wake_blob(prob):
    """The example's actuation: a smooth vertical body-force pattern
    behind the cylinder, zero on the boundary dofs."""
    xy = prob.space.p2_coords
    blob = np.exp(-(((xy[:, 0] - 0.3) / 0.08) ** 2
                    + ((xy[:, 1] - 0.2) / 0.08) ** 2))
    b = np.zeros(prob.nv_full)
    b[1::2] = blob
    b[prob.bcinds] = 0.0
    return b


def timed_sync(fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def adjoint_path(dev, gen):
    """The discrete adjoint on the card: ``vecmat_t`` and ``conv_vjp``
    against their plain versions at the shapes of the path (level 1 and
    2); at level 1 the example's gradient in the schedule against the
    CPU f64 port gradient (1e-4 of its largest entry), exact launch
    counts, three Armijo descent steps that lower the misfit; at level 2
    the adjoint identity ``<jvp(d), w> = <d, vjp(w)>`` (1e-5 relative)
    with exact launch counts.  Returns the kernel rows' data."""
    n = ADJ_STEPS
    rows = {}
    # -- level 1: the example's configuration ------------------------------
    prob = cylinderwake_problem(level=LEVEL, Re=ADJ_RE, charvel=CHARVEL)
    v0 = steady_inner(prob)
    b = wake_blob(prob)
    amps_true = torch.as_tensor(
        1e-3 * np.sin(np.pi * np.linspace(0, 1, n)) ** 2, device=dev)
    (sim,), setup_s = timed_sync(lambda: (make_diff_cnab(
        prob, ADJ_DT, bvec=b),))
    ZpT = next(iter(prob._full_layouts.values()))["ZpT"]
    x = torch.randn(ZpT.shape[1], generator=gen).to(dev)
    rows["vecmat_t"] = check_vecmat_t(x, ZpT, "ZpT, level 1", 50)
    kern = prob.conv_kernel_on(torch.float32)
    aff = next(iter(prob._full_layouts.values()))["aff"]
    u = prob.embed(v0)
    rows["conv_vjp"] = check_conv_vjp(kern, aff, u, gen,
                                      "the steady state, level 1", True)
    with torch.no_grad():
        v_obs = sim(v0, amps_true)

    def cost(amps):
        return 0.5 * ((sim(v0, amps) - v_obs) ** 2).sum()

    def value_and_grad(amps):
        a = amps.detach().requires_grad_(True)
        c = cost(a)
        (g,) = torch.autograd.grad(c, a)
        return float(c.detach()), g

    zeros = torch.zeros(n, dtype=torch.float64, device=dev)
    value_and_grad(zeros)                      # warm (one-off set-ups)
    zero_counts()
    (c0, g), grad_s = timed_sync(lambda: value_and_grad(zeros))
    got = adj_counts()
    want = adjoint_counts(n, "amps")
    require(got == want, f"launches of a level-1 gradient: {got} != {want}")
    busy_ms, nkern, busy_wall = busy_share(lambda: value_and_grad(zeros))
    # the CPU f64 port gradient (the reference; f64 tables and work)
    cprob = cylinderwake_problem(level=LEVEL, Re=ADJ_RE, charvel=CHARVEL,
                                 device="cpu")
    t0 = time.time()
    csim = make_diff_cnab(cprob, ADJ_DT, bvec=b, device="cpu")
    with torch.no_grad():
        cobs = csim(v0, amps_true.cpu())
    ca = torch.zeros(n, dtype=torch.float64, requires_grad=True)
    (0.5 * ((csim(v0, ca) - cobs) ** 2).sum()).backward()
    cpu_s = time.time() - t0
    gc = ca.grad
    grad_err = float((g.cpu() - gc).abs().max() / gc.abs().max())
    require(bool(torch.isfinite(g).all()) and grad_err <= 1e-4,
            f"level-1 gradient, card vs CPU f64: {grad_err:.3e} > 1e-4")
    del csim, cprob
    # three Armijo descent steps on the misfit
    amps, c, gk = zeros, c0, g
    lr = c0 / float(g @ g)
    costs = [c0]
    for _ in range(3):
        for _ in range(30):
            trial = amps - lr * gk
            with torch.no_grad():
                ct = float(cost(trial))
            if ct <= c - 1e-4 * lr * float(gk @ gk):
                break
            lr *= 0.5
        require(ct < c, f"Armijo step found no descent: {ct} >= {c}")
        amps = trial
        c, gk = value_and_grad(amps)
        costs.append(c)
    require(costs[-1] < costs[0], f"misfit not lowered: {costs}")
    level1 = dict(problem="cylinderwake level 1, Re 40", steps=n, dt=ADJ_DT,
                  nv_full=prob.nv_full, zpt=list(ZpT.shape),
                  setup_seconds=setup_s, gradient_seconds=grad_s,
                  launches=got, device_busy_ms=busy_ms,
                  device_kernels=nkern, busy_share=(
                      None if busy_ms is None
                      else 1e-3 * busy_ms / busy_wall),
                  grad_rel_err_vs_cpu_f64=grad_err, bar=1e-4,
                  cpu_f64_seconds=cpu_s, misfit=costs)
    rows["launches"] = got
    del sim, ZpT
    prob._full_layouts.clear()
    torch.cuda.empty_cache()

    # -- level 2: the adjoint identity -------------------------------------
    prob2 = cylinderwake_problem(level=LEVEL2, Re=ADJ_RE, charvel=CHARVEL)
    v02 = torch.as_tensor(steady_inner(prob2, only_stokes=True), device=dev)
    (sim2,), setup2_s = timed_sync(lambda: (make_diff_cnab(prob2, ADJ_DT),))
    lay2 = next(iter(prob2._full_layouts.values()))
    x = torch.randn(lay2["ZpT"].shape[1], generator=gen).to(dev)
    rows["vecmat_t_level2"] = check_vecmat_t(x, lay2["ZpT"], "ZpT, level 2",
                                             20)
    rows["conv_vjp_level2"] = check_conv_vjp(
        prob2.conv_kernel_on(torch.float32), lay2["aff"], prob2.embed(v02),
        gen, "the Stokes state, level 2", True)
    nin2 = len(prob2.invinds)
    d, w = (torch.randn(nin2, generator=gen, dtype=torch.float64).to(dev)
            for _ in range(2))
    zeros = torch.zeros(n, dtype=torch.float64, device=dev)
    zero_counts()
    (_, tang), jvp_s = timed_sync(lambda: torch.func.jvp(
        lambda v: sim2(v, zeros), (v02,), (d,)))
    jvp_counts = adj_counts()
    want = adjoint_counts(n, "jvp")
    require(jvp_counts == want,
            f"launches of a level-2 JVP: {jvp_counts} != {want}")

    def vjp():
        v = v02.clone().requires_grad_(True)
        return torch.autograd.grad(sim2(v, zeros), v, w)[0]

    zero_counts()
    gv, vjp_s = timed_sync(vjp)
    vjp_counts = adj_counts()
    want = adjoint_counts(n, "v0")
    require(vjp_counts == want,
            f"launches of a level-2 gradient: {vjp_counts} != {want}")
    require(bool(torch.isfinite(tang).all() and torch.isfinite(gv).all()),
            "level-2 derivatives not finite")
    lhs, rhs = float(tang @ w), float(d @ gv)
    ident = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
    require(ident <= 1e-5, f"adjoint identity at level 2: {lhs} vs {rhs}")
    level2 = dict(problem="cylinderwake level 2, Re 40", steps=n,
                  nv_full=prob2.nv_full, zpt=list(lay2["ZpT"].shape),
                  setup_seconds=setup2_s, jvp_seconds=jvp_s,
                  gradient_seconds=vjp_s, jvp_launches=jvp_counts,
                  gradient_launches=vjp_counts, jvp_dot_w=lhs,
                  d_dot_vjp=rhs, identity_rel_err=ident, bar=1e-5)
    rows["launches_level2"] = vjp_counts
    del sim2, lay2
    prob2._full_layouts.clear()
    torch.cuda.empty_cache()
    say(phase="adjoint_path", level1=level1, level2=level2,
        vecmat_t=[rows["vecmat_t"], rows["vecmat_t_level2"]],
        conv_vjp=rows["conv_vjp"] + rows["conv_vjp_level2"])
    return rows


def adjoint_rows(rows):
    """The kernels line's rows of the backward kernels: the launches of one
    gradient of the example (level 1) and of one level-2 gradient."""
    out = []
    for sfx, launches in (("", rows["launches"]),
                          ("_level2", rows["launches_level2"])):
        vt = rows["vecmat_t" + sfx]
        cv = next(r for r in rows["conv_vjp" + sfx] if "ms" in r)
        out += [
            dict(name="vecmat_t" + sfx, route="cuda",
                 source="dolfin_navier_scipy_tpu_torch/csrc/vecmat.cu",
                 replaces=ADJ_REPLACES["vecmat_t"],
                 launches=launches["vecmat_t"], shape=vt["shape"],
                 max_abs_err=vt["max_abs_err"], ms=vt["ms"],
                 plain_ms=vt["plain_ms"], bound_ms=vt["bound_ms"],
                 bound_by=vt["bound_by"], library_ms=vt["library_ms"],
                 library_eager_ms=vt.get("library_eager_ms"),
                 library=vt["library"], eager_ms=vt["eager_ms"],
                 grid_blocks=vt["grid_blocks"],
                 resident_blocks=vt["resident_blocks"],
                 device_kernels_per_call=vt["device_kernels_per_call"]),
            dict(name="conv_vjp" + sfx, route="cuda",
                 source="dolfin_navier_scipy_tpu_torch/csrc/convection.cu",
                 replaces=ADJ_REPLACES["conv_vjp"],
                 launches=launches["conv_vjp"],
                 shape=dict(nc=cv["nc"], nv_full=cv["nv_full"],
                            facet_blocks=cv["facet_blocks"],
                            tables=cv["tables"], state=cv["state"]),
                 max_abs_err=cv["max_abs_err"], ms=cv["ms"],
                 plain_ms=cv["plain_ms"], bound_ms=cv["bound_ms"],
                 bound_by=cv["bound_by"], library_ms=None,
                 eager_ms=cv["eager_ms"],
                 device_kernels_per_call=cv["device_kernels_per_call"])]
    return out


def checkpoint_path(dev):
    """The default call at level 1 split by ``save_data`` and
    ``checkpoint_every`` into sections, then resumed by ``useolddata``
    from the last checkpoint but one: the same bits as the uninterrupted
    run; a PVD series and a ``Timer`` trace of the resumed run written.
    Files go under ``build/`` of this checkout and are removed."""
    import shutil

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_checkpoint")
    shutil.rmtree(root, ignore_errors=True)
    prob = cylinderwake_problem(level=LEVEL, Re=RE, charvel=CHARVEL)
    nts, every = 60, 20
    kw = dict(t0=T0, tE=T0 + nts * (TE - T0) / NTS, Nts=nts,
              start_ssstokes=True, save_every=every, checkpoint_every=every,
              data_prfx=os.path.join(root, "data", "wake"))
    (full,), full_s = timed_sync(lambda: (solve_nse(
        prob=prob, save_data=True, paraviewoutput=True,
        vfileprfx=os.path.join(root, "vtk", "vel"), **kw),))
    carries = sorted(glob.glob(kw["data_prfx"] + "*__carry.npz"))
    require(len(carries) == nts // every, f"checkpoints: {carries}")
    require(isinstance(full["ops"].solver, SchurSaddleSolver),
            "the default call at level 1 takes the Schur solver")
    last = [f for f in carries if f"time{kw['tE']:.5e}" in f]
    require(len(last) == 1, f"the final checkpoint: {carries}")
    os.remove(last[0])
    zero_counts()
    with Timer("resumed", trace_dir=os.path.join(root, "trace"),
               verbose=False, device=dev) as tm:
        resumed = solve_nse(prob=prob, useolddata=True, **kw)
    same = all(torch.equal(resumed[k], full[k]) for k in ("v", "p"))
    require(same, "the resumed run differs from the uninterrupted one")
    require(bool(torch.isfinite(full["v"]).all()), "not finite")
    pvd = open(full["pvdfile"]).read()
    nvtu = len(glob.glob(os.path.join(root, "vtk", "vel_*.vtu")))
    require(pvd.count("<DataSet") == nvtu == len(full["times"]) > 0,
            f"PVD series: {nvtu} files")
    trace_events = len(json.load(open(tm.trace_file))["traceEvents"])
    require(trace_events > 0, "empty Timer trace")
    say(phase="checkpoint_path", problem="cylinderwake level 1, Re 100",
        call=f"solve_nse(prob, t0, tE, Nts={nts}, start_ssstokes=True, "
             f"save_data=True, checkpoint_every={every}) then useolddata",
        sections=nts // every, checkpoints=len(carries),
        uninterrupted_seconds=full_s, resumed_seconds=tm.elapsed,
        resumed_launches=counts(), bitwise_equal=same, pvd_files=nvtu,
        trace_events=trace_events)
    shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# 3D: the Schaefer-Turek 3D-2Z wake on tets, both block-Schur routes
# ---------------------------------------------------------------------------

# Schaefer-Turek 3D-2Z: channel 2.5 x 0.41 x 0.41, cylinder at (0.5, 0.2),
# no-slip z-walls, paraboloid inflow of peak 2.25 charvel, Re = 100
WAKE3D = dict(level=0, nu=1e-3, charvel=1.0, paraboloid_inflow=True,
              zslip=False, length=2.5, center=(0.5, 0.2))
NTS3D, DT3D = 100, 1e-3
NZ_SMALL, NZ_PATH = 2, 8
PCG_WRAPPERS = (pcg_init, pcg_step, block_pcg_init, block_pcg_step)
PCG_REPLACES = dict(vector="dolfin_navier_scipy_tpu/solve/sadpnt.py:677",
                    block="dolfin_navier_scipy_tpu/solve/sadpnt.py:252")
PCG_DESIGN = ("one launch after the matvec: a resident grid, two fixed-order "
              "reductions through per-block partials and a grid barrier "
              "each, the scalars on the device")
CONV3D_DESIGN = ("a 128-thread block an element, a thread a quadrature "
                 "point, the 30 element sums in point order, then the "
                 "grid barrier and the dof-major ELL sums")
AFFINE3D_DESIGN = ("the 2D form's partitions, never split; a block's ids, "
                   "geometry, slot table and reference matrices by bulk "
                   "copies, x gathered for all its slots in one pass; "
                   "velocity slots a warp an element (the lane's Sref rows "
                   "in registers, Z shared by shuffles), pressure slots a "
                   "thread an (element, node); exact reference matrices")
ELEM30_DESIGN = ("the 2D form's partition and tables; each warp's 32 rows "
                 "copied by cp.async (8-byte pieces, neighbouring lanes on "
                 "neighbouring bytes) into its stage in shared memory, a "
                 "row a lane from there; a thread a dof summing its rows "
                 "in slot order")


# sha256 (first 16 hex digits) of y from the first 3D forms of
# csrc/elemmv.cu and csrc/affine.cu (commit 541cd06) on the seeded
# operands of elem3d_bits_cases and affine3d_bits_cases (3D-2Z, nz=2): the
# redesigned kernels keep every chain and every dof's slot order, so they
# must give these bits (tools_torch/elemmv_variants.py and
# affine_variants.py --wake3d 2 print them for any checkout)
ELEM3D_BITS = {
    "F 30x30, E float32, x float32": "efeee3ace69e6844",
    "F 30x30, E float64, x float64": "7b9a53a1d05b11c2",
    "F 30x30, E float64, x float32": "eca10a6baf4bc618",
    "J 4x30, E float32, x float32": "b80223e4967ca074",
    "J 4x30, E float64, x float64": "563ddac5df40df13",
    "J 4x30, E float64, x float32": "081cdef9b7392d1e",
    "J^T, E float32, x float32": "07da98d06afd7d23",
    "J^T, E float64, x float64": "c512b3c67b2c3f3a",
    "J^T, E float64, x float32": "db31bca9ce4b3302"}
AFFINE3D_BITS = {
    "m, tables float32, x float32": "62dc360676e2a861",
    "m, tables float32, x float64": "04918b0e1ba6e505",
    "a, tables float32, x float32": "2f850e3b6db63ff4",
    "a, tables float32, x float64": "69466252476e4206",
    "ma, tables float32, x float32": "d4328ef8595da101",
    "ma, tables float32, x float64": "a4fa6a4bc546b1cc",
    "j, tables float32, x float32": "60d48e812e3c81f0",
    "j, tables float32, x float64": "676debf1ced227c4",
    "jt, tables float32, x float32": "74926b6bcefca5a7",
    "jt, tables float32, x float64": "c862f099af1d98b3",
    "res, tables float32, x float32": "e528c1613755cbde",
    "res, tables float32, x float64": "a5bca16d354e57c8",
    "m, tables float64, x float32": "abbcf9e66e8ff728",
    "m, tables float64, x float64": "78045c2ce0084bac",
    "a, tables float64, x float32": "34bc316069d062f2",
    "a, tables float64, x float64": "02418061ffa5a464",
    "ma, tables float64, x float32": "237ccd9177947f87",
    "ma, tables float64, x float64": "08686b0dfc75887f",
    "j, tables float64, x float32": "78d12c10fd881f12",
    "j, tables float64, x float64": "66553dea28ea425e",
    "jt, tables float64, x float32": "96354349e52f9e78",
    "jt, tables float64, x float64": "af9c9235fd8e2b3e",
    "res, tables float64, x float32": "7ab2c7457007cf2d",
    "res, tables float64, x float64": "3e8f40df8c82e3c0"}


def elem3d_bits_cases(prob, dev):
    """``[(name, E, x, in_tab, out_tab, transpose)]`` on a 3D problem's
    tables: the element route's full-dof velocity table (F's 30 x 30
    blocks, as ``solve_nse`` builds it) and the divergence's (J 4 x 30, its
    transpose), seeded as :func:`elem_bits_cases`'s."""
    _, _, J = build_element_ops(prob, dtype=torch.float64, device=dev)
    vd = prob.space.vdofs_of_cells()
    ftab = kernels.DofTable(torch.as_tensor(vd.reshape(vd.shape[0], -1),
                                            device=dev), prob.nv_full)
    return seeded_elem_cases((
        ("F 30x30", (vd.shape[0], 30, 30), ftab, ftab, False),
        ("J 4x30", J.elem.shape, J.vtab, J.ptab, False),
        ("J^T", J.elem.shape, J.ptab, J.vtab, True)), 30, dev)


def affine3d_bits_cases(prob, dev):
    """``[(name, tables, mode, cm, ca, x, q)]``: the full-dof 3D tables in
    f32 and f64, every mode of ``AFFINE_MODES`` (the residual 'res'),
    seeded f32 and f64 vectors."""
    rng = np.random.default_rng(31)
    out = []
    for tdt in (torch.float32, torch.float64):
        aff = AffineVectorOps.build(prob, tdt, full_dofs=True, device=dev)
        for mode, cm, ca in AFFINE_MODES:
            n = aff.npc if mode == "jt" else aff.nin
            for xdt in (torch.float32, torch.float64):
                x = torch.as_tensor(rng.normal(size=n)).to(dev, xdt)
                q = torch.as_tensor(rng.normal(size=aff.npc)).to(dev, xdt)
                out.append((f"{mode}, tables {str(tdt)[6:]}, x "
                            f"{str(xdt)[6:]}", aff, mode, cm, ca, x, q))
    return out


def affine_bits(mod, cases):
    """``{name: the first 16 hex digits of sha256(y)}`` of the affine
    kernel of ``mod`` (a module with ``affine_mv`` and
    ``affine_residual``: this checkout's ``ops.kernels`` or another's) on
    ``cases``, each table set on plans of its own."""
    out, own = {}, {}
    for name, aff, mode, cm, ca, x, q in cases:
        t = own.setdefault(id(aff), fresh_tables(aff))
        y = (mod.affine_residual(x, q, t, cm, ca) if mode == "res"
             else mod.affine_mv(mode, x, t, cm, ca))
        out[name] = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
    return out


def pcg_counts():
    return {w.__name__: w.launches for w in PCG_WRAPPERS}


def all_counts():
    return {**counts(), **pcg_counts()}


def wake3d(nz):
    t0 = time.time()
    prob = cylinderwake3d_problem(nz=nz, **WAKE3D)
    return prob, time.time() - t0


def elem_counts_want(nsteps, refine, niter):
    """Launches of a 3D CNAB run on the element route with ``warm_refine``
    ``refine``: per loop step the fused convection, and per solve (one plus
    one a refine round) a warm (or cold) PCG of ``niter`` iterations (F x0
    on the warm one, the residual's F v on a round), J y, ``S^-1`` and X by
    ``vecmat``, the round's J^T q and J v; the bootstrap's three convection
    vectors and the AB2 start."""
    s, r = nsteps, refine
    return dict(vecmat=2 * s * (1 + r), conv_vector=4,
                conv_vector_amatvec=s, banded_mv=0, rect_mv=0,
                rect_mv_levels=0, affine_mv=s * (1 + 3 * r),
                affine_residual=0, elem_mv=s * (1 + niter) * (1 + r),
                pcg_init=s * (1 + r), pcg_step=s * niter * (1 + r),
                block_pcg_init=0, block_pcg_step=0)


def band_counts_want(slv, nsteps, refine, niter):
    """The same on the banded route (w-space): with W as in the level-1
    Schur path; without W each solve is a warm PCG over the banded F (B7
    after each banded_mv)."""
    s, r = nsteps, refine
    want = dict(vecmat=0, conv_vector=s + 4, conv_vector_amatvec=0,
                rect_mv=s * (1 + 3 * r), affine_mv=0, affine_residual=0,
                elem_mv=0, block_pcg_init=0, block_pcg_step=0)
    if slv.Wb is not None:
        want.update(banded_mv=s * (1 + r), rect_mv_levels=3 * s * (1 + r),
                    pcg_init=0, pcg_step=0)
    else:
        want.update(banded_mv=s * (1 + (1 + niter) * (1 + r)),
                    rect_mv_levels=2 * s * (1 + r), pcg_init=s * (1 + r),
                    pcg_step=s * niter * (1 + r))
    return want


def pcg_bound_ms(n, k, itemsize):
    """Least time for one PCG tail: x, r, p, F p and dinv read once, x, r
    and p written once (``k`` columns each, dinv once); ~10 operations an
    entry over the rate of the type."""
    kk = max(k, 1)
    nbytes = itemsize * (8 * n * kk + n)
    ops = 10.0 * n * kk
    rate = F32_FLOP_PER_S if itemsize == 4 else F64_FLOP_PER_S
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / rate
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def check_pcg(fmv, dinv, n, k, what, gen, niter):
    """B7 against its plain version: ``niter`` iterations of the kernel
    and of the plain tail from the same start, each after its own matvec
    ``fmv`` (vector form, ``k`` 0) or on ``k`` columns; the iterate and
    ``rz`` within 1e-4 relative in f32 (1e-10 in f64: the two sum in
    other orders, and CG carries that through its iterations), the same
    bits on a rerun, one kernel node a call; timed by graph replay beside
    its plain version (no single library call computes the tail)."""
    dev = dinv.device
    shape = (n,) if k == 0 else (n, k)
    b = torch.randn(shape, generator=gen, dtype=torch.float64).to(
        device=dev, dtype=dinv.dtype)
    init, step = ((pcg_init, pcg_step) if k == 0
                  else (block_pcg_init, block_pcg_step))
    init_ref, step_ref = ((pcg_init_ref, pcg_step_ref) if k == 0
                          else (block_pcg_init_ref, block_pcg_step_ref))

    def run(kernel):
        st = list(init(b, dinv) if kernel else init_ref(b, dinv))
        for _ in range(niter):
            (step if kernel else step_ref)(*st[:3], fmv(st[2]), dinv, st[3])
        return st

    got, again, ref = run(True), run(True), run(False)
    torch.cuda.synchronize()
    err = rel(got[0], ref[0])
    rz_err = float(((got[3] - ref[3]).abs() / ref[3].abs()).max())
    bar = 1e-4 if dinv.dtype == torch.float32 else 1e-10
    require(err <= bar and rz_err <= bar, f"B7 ({what}) disagrees with its "
            f"plain version after {niter} iterations: x {err:.3e}, rz "
            f"{rz_err:.3e} > {bar}")
    require(all(torch.equal(a_, b_) for a_, b_ in zip(got, again)),
            f"B7 ({what}) is not reproducible")
    # the timed calls iterate on copies (the state runs on past the check)
    st = [t.clone() for t in got]
    ap = fmv(st[2])

    def one():
        step(st[0], st[1], st[2], ap, dinv, st[3])

    stp = [t.clone() for t in st]

    def one_plain():
        step_ref(stp[0], stp[1], stp[2], ap, dinv, stp[3])

    max_abs = float((got[0] - ref[0]).abs().max())
    ran, types = device_kernels(one)
    require(ran == 1, f"B7 ({what}) ran {ran} device kernels ({types})")
    bound, by = pcg_bound_ms(n, k, dinv.element_size())
    ms = graph_ms(one)
    return dict(name=step.__name__, operand=what, n=n, k=k,
                dtype=str(dinv.dtype), iterations=niter, rel_err=err,
                rz_rel_err=rz_err, max_abs_err=max_abs,
                device_kernels_per_call=ran, ms=ms,
                eager_ms=time_ms(one, 200), plain_ms=graph_ms(one_plain),
                library_ms=None, bound_ms=bound, bound_by=by,
                roofline_share=bound / ms)


def affine3d_bound_ms(t, mode, x_item, facets):
    """Least time for one 3D affine call (the exact reference-matrix form
    the kernel applies): the vectors, the int32 ids, JinvT and detJ, the
    reference matrices and the facet blocks read once, the output written
    once; the operations the function needs over the rate of the work
    type, counting a multiply-add as two: a velocity slot (a, c) forms its
    own component of Z = Sref x (90 multiply-adds), contracts it with the
    element's metric JinvT^T JinvT (9; the metric's 27 once an element)
    and, symmetric, with JinvT (27 + 9); M a slot is 10 + 1, J a pressure
    node 99, J^T a slot 15; each slot is then added once into its dof."""
    s = t.wdet.element_size()
    nc, nd, pn = t.nc, t.nvpc * t.dim, t.pnpc
    nfac = int(t.fac_elem.shape[0]) if facets else 0
    nin = dict(jt=t.npc, res=t.nin + t.npc).get(mode, t.nin)
    nout = dict(j=t.npc, res=t.nin + t.npc).get(mode, t.nin)
    ids = dict(jt=pn, res=nd + pn).get(mode, nd)
    nbytes = (x_item * (nin + nout) + 4 * nc * ids + s * nc * 10
              + s * 1120 + nfac * nd * (s * nd + 4))
    sym = bool(t.sym)
    per = dict(m=nd * 22 + 1,
               a=nd * (2 * (90 + 9 + 36 * sym) + sym + 1) + 2 * 27 + 2,
               j=pn * (2 * 99 + 1), jt=nd * (2 * 15 + 1))
    per["ma"] = per["m"] + per["a"]
    per["res"] = per["ma"] + per["jt"] + per["j"]
    sums = dict(j=pn, res=2 * nd + pn).get(mode, nd)
    flops = nc * (per[mode] + sums) + 2 * nfac * nd * nd
    rate = F32_FLOP_PER_S if s == 4 else F64_FLOP_PER_S
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def kernels3d(prob, slv_elem, slv_band, what, gen, timed):
    """K1-K4 on the 3D operands of ``prob``: the convection kernel (f32
    tables, f64 and f32 states, both sym, the outflow facet blocks), the
    affine kernel in every mode and the residual (f32 tables, full dofs),
    B10 on the element route's F blocks (30 x 30) and J / J^T (4 x 30),
    B7 on the element route's F (vector form) and on a block of 256
    columns of the banded F (the device setup's form)."""
    dev = torch.device("cuda")
    kern = prob.conv_kernel_on(torch.float32, dev)
    aff = slv_elem.res_ops[1].aff
    u = torch.randn(prob.nv_full, generator=gen, dtype=torch.float64).to(dev)
    u2 = torch.randn(prob.nv_full, generator=gen,
                     dtype=torch.float64).to(dev)
    conv = check_conv(kern, aff, aff.fac_dofs, u, u2, what, True, timed,
                      counted=timed)
    conv += check_conv(kern, aff, aff.fac_dofs, u.float(), u2.float(),
                       what + ", f32 state", True, False)
    bound_fn = globals()["affine_bound_ms"]
    globals()["affine_bound_ms"] = affine3d_bound_ms
    try:
        affc = check_affine(aff, prob, True, what, gen,
                            timed=(dict.fromkeys(
                                ("m", "a", "ma", "j", "jt", "res"),
                                torch.float32) if timed else None),
                            counted=timed)
    finally:
        globals()["affine_bound_ms"] = bound_fn
    F = slv_elem.res_ops[0]
    el = [check_elem(F.elem, F.tab, F.tab, False, what + ", F = M + dt/2 A",
                     gen, ELEM_REPLACES["op"])]
    if timed:
        _, _, J = build_element_ops(prob, dtype=torch.float32, device=dev)
        el.append(check_elem(J.elem, J.vtab, J.ptab, False,
                             what + ", DivElementOp J", gen,
                             ELEM_REPLACES["div"]))
        el.append(check_elem(J.elem, J.ptab, J.vtab, True,
                             what + ", DivElementOp J^T", gen,
                             ELEM_REPLACES["div"]))
    pcg = [check_pcg(F.matvec, slv_elem.dinv, slv_elem.nv, 0,
                     what + ", element route F", gen, slv_elem.ncg)]
    B = slv_band._op["B"]
    dpad = torch.zeros(B.shape[0] * B.shape[1], dtype=torch.float32,
                       device=dev)
    dpad[:slv_band._nin] = slv_band.dinv_b
    pcg.append(check_pcg(lambda P: _tridiag_bmm(B, P), dpad, dpad.shape[0],
                         256, what + ", banded F, 256 columns", gen, 12))
    return dict(conv=conv, affine=affc, elem=el, pcg=pcg)


def nse3d(prob, dev, **kw):
    """One user call: ``solve_nse`` over ``NTS3D`` steps of ``DT3D``, with
    its launches (zeroed just before, read just after) and host seconds."""
    zero_counts()
    t0 = time.time()
    out = solve_nse(prob=prob, t0=0.0, tE=NTS3D * DT3D, Nts=NTS3D,
                    device=dev, **kw)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    return out, dict(all_counts(), affine_modes=dict(
        affine_mv.mode_launches)), seconds


def route_info(out):
    slv = out["ops"].solver
    return dict(route="banded" if slv.banded else "element",
                setup=slv.setup, W=getattr(slv, "Wb", None) is not None,
                setup_timing=slv.setup_timing,
                loop_ms_per_step=1e3 * out["timing"]["loop_s"] / (NTS3D - 1))


def check3d_run(prob, out, c, want, what):
    require(not out["ffflag"], f"{what}: blow-up flag")
    v = out["v"]
    require(bool(torch.isfinite(v).all()) and v.shape[0] == len(prob.invinds),
            f"{what}: final v")
    got = {k: c[k] for k in want}
    require(got == want, f"{what}: launches {got} != {want}")
    div = divergence_rel(prob, v)
    require(div <= 1e-6, f"{what}: divergence {div:.3e} > 1e-6")
    return div


def w_truncation(prob, slv, gen, nvec=4):
    """``|W b - F^-1 b| / |F^-1 b|`` of the banded solver's truncated
    inverse (all its levels) on ``nvec`` seeded vectors, ``F^-1 b`` by an
    f64 host solve: what an unrefined W-route solve leaves."""
    if slv.Wb is None:
        return None
    F = sps.csc_matrix(prob.Mc + 0.5 * DT3D * prob.Ac)
    full2in = np.full(prob.nv_full, -1, np.int64)
    full2in[prob.invinds] = np.arange(len(prob.invinds))
    perm = full2in[slv.permf.cpu().numpy()]
    lu = spla.splu(F)
    out = []
    for _ in range(nvec):
        b = torch.randn(F.shape[0], generator=gen,
                        dtype=torch.float64).numpy()
        x = lu.solve(b)[perm]
        y = slv._wapply(torch.as_tensor(b[perm], dtype=torch.float32,
                                        device=slv.Wb.device))
        out.append(float(np.linalg.norm(y.double().cpu().numpy() - x)
                         / np.linalg.norm(x)))
    return out


def wake3d_small(dev, gen):
    """3D-2Z at nz=2 (the oracle size): the default call (banded route)
    and the element route (``banded=False``), ``warm_refine`` 0 and 1,
    against the CPU f64 run of the element route with host setup (1e-4 /
    1e-6; the banded route's unrefined W solve: wtol times the run's
    relative change of v, see below); divergence, exact launches; K1-K4
    against their plain versions on this problem's operands."""
    prob, build_s = wake3d(NZ_SMALL)
    vss, pss = solve_steadystate_nse(prob, only_stokes=True, return_vp=True,
                                     linsolver="host-sparse", device=dev)
    ini = dict(iniv=vss.ravel()[prob.invinds], inip=pss.ravel())
    t0 = time.time()
    ref = solve_nse(prob=prob, t0=0.0, tE=NTS3D * DT3D, Nts=NTS3D,
                    linsolver="schur", banded=False, warm_refine=1,
                    device="cpu", **ini)
    cpu_s = time.time() - t0
    require(not ref["ops"].solver.banded and ref["ops"].solver.setup ==
            "host", "the CPU reference is the element route, host setup")
    vref = ref["v"]
    runs, ops = {}, {}
    for name, kw in (("banded", {}), ("element", dict(banded=False))):
        for r in (0, 1):
            out, c, s = nse3d(prob, dev, warm_refine=r,
                              ops=ops.get(name), **ini, **kw)
            ops[name] = out["ops"]
            slv = out["ops"].solver
            require(slv.banded == (name == "banded"), f"{name}: route")
            want = (band_counts_want(slv, NTS3D - 1, r, NITER_WARM)
                    if slv.banded else elem_counts_want(NTS3D - 1, r,
                                                        NITER_WARM))
            if r == 0:
                # the first call builds the solver (W's block PCG: B7)
                want = {k: w for k, w in want.items()
                        if not k.startswith("block_pcg")}
            div = check3d_run(prob, out, c, want, f"wake3d_small {name} r{r}")
            err = rel(out["v"], vref)
            runs[f"{name}_refine{r}"] = dict(
                rel_err_vs_cpu_f64=err, bar=1e-4 if r == 0 else 1e-6,
                divergence=div, seconds=s, launches=c, **route_info(out))
    # the unrefined W route's bar: W's truncation (wtol) imprints on every
    # increment and, W being one fixed operator, the imprints add up with
    # the increments: wtol times the run's relative change of v (36 % from
    # the Stokes start here), where the 2D runs' 1e-4 comes from runs that
    # move far less (the JAX package records 1.9e-4 for its own unrefined
    # W route at level 2, README); the other runs keep 1e-4 / 1e-6
    wtol = inspect.signature(SchurSaddleSolver).parameters["wtol"].default
    moved = float(np.linalg.norm(vref.numpy() - ini["iniv"])
                  / np.linalg.norm(vref.numpy()))
    wtrunc = w_truncation(prob, ops["banded"].solver, gen)
    for name, run in runs.items():
        if name == "banded_refine0" and run["W"]:
            run["bar"] = max(run["bar"], wtol * moved)
            run["bar_from"] = "wtol x the run's relative change of v"
    say(phase="wake3d_small_runs", runs=runs, cpu_reference_seconds=cpu_s,
        v_moved_rel=moved, wtol=wtol, w_truncation=wtrunc)
    for name, run in runs.items():
        require(run["rel_err_vs_cpu_f64"] <= run["bar"],
                f"wake3d_small {name}: {run['rel_err_vs_cpu_f64']:.3e} from "
                f"the CPU f64 run > {run['bar']}")
    chk = kernels3d(prob, ops["element"].solver, ops["banded"].solver,
                    f"wake3d nz={NZ_SMALL}", gen, timed=False)
    bits = dict(elem=elem_bits(elem_mv, elem3d_bits_cases(prob, dev)),
                affine=affine_bits(kernels, affine3d_bits_cases(prob, dev)))
    require(bits["elem"] == ELEM3D_BITS, f"elem_mv (3D): other bits than "
            f"the first 3D kernel's: {bits['elem']} != {ELEM3D_BITS}")
    require(bits["affine"] == AFFINE3D_BITS, f"affine (3D): other bits than "
            f"the first 3D kernel's: {bits['affine']} != {AFFINE3D_BITS}")
    say(phase="wake3d_small", problem=f"3D-2Z nz={NZ_SMALL}",
        same_bits_as_first_3d_kernels=True,
        nv_full=prob.nv_full, nin=len(prob.invinds), np=prob.np_cond,
        tets=prob.space.mesh.num_cells, build_seconds=build_s,
        cpu_reference_seconds=cpu_s, runs=runs,
        checks={k: [{kk: vv for kk, vv in c_.items() if kk != "plan"}
                    for c_ in v] for k, v in chk.items()})


def step_share(prob, dev, ops, ini, refine, kw, short=11, long=41):
    """Device busy ms, device kernels and wall ms a loop step of a route
    (``ops`` reused): two profiled user calls of ``short`` and ``long``
    steps, differenced, so that the bootstrap and the calls' fixed costs
    drop out (the profiler's own overhead stays in the wall).  None where
    the profiler saw no device event."""
    got = {}
    for n in (short, long):
        got[n] = busy_share(lambda n=n: solve_nse(
            prob=prob, t0=0.0, tE=n * DT3D, Nts=n, device=dev,
            warm_refine=refine, ops=ops, **ini, **kw))
    d = long - short
    (b0, k0, w0), (b1, k1, w1) = got[short], got[long]
    wall = 1e3 * (w1 - w0) / d
    if b0 is None or b1 is None:
        return dict(busy_ms=None, kernels=None, wall_ms=wall,
                    busy_share=None)
    busy = (b1 - b0) / d
    return dict(busy_ms=busy, kernels=(k1 - k0) / d, wall_ms=wall,
                busy_share=busy / wall if wall > 0 else None)


def wake3d_path(dev, gen):
    """3D-2Z at full width (nz=8): the default call (banded route, device
    setup) and ``banded=False`` (element route, device setup), refine 0
    and 1; the two routes' refine-1 runs agree to 1e-6, each refine 0
    within 1e-4 of its refine 1; divergence; a bitwise rerun of the element
    route; exact launches; setup parts and loop ms a step; K1-K4 timed
    beside their bounds and the library's CSR matvecs."""
    prob, build_s = wake3d(NZ_PATH)
    t0 = time.time()
    vss, pss = solve_steadystate_nse(prob, only_stokes=True, return_vp=True,
                                     linsolver="host-sparse", device=dev)
    stokes_s = time.time() - t0
    ini = dict(iniv=vss.ravel()[prob.invinds], inip=pss.ravel())
    F = sps.csr_matrix(prob.Mc + 0.5 * DT3D * prob.Ac)
    band_gb = SchurSaddleSolver.__init__.__globals__[
        "_banded_bandwidth_gb"](F)
    runs, ops, outs, launches = {}, {}, {}, {}
    for name, kw in (("banded", {}), ("element", dict(banded=False))):
        for r in (0, 1):
            out, c, s = nse3d(prob, dev, warm_refine=r, ops=ops.get(name),
                              **ini, **kw)
            ops[name] = out["ops"]
            slv = out["ops"].solver
            require(slv.banded == (name == "banded") and slv.setup ==
                    "device", f"{name}: route and setup")
            want = (band_counts_want(slv, NTS3D - 1, r, NITER_WARM)
                    if slv.banded else elem_counts_want(NTS3D - 1, r,
                                                        NITER_WARM))
            if r == 0:
                # the first call builds the solver: its setup's B7 launches
                # (the device setup's block PCG) are reported, not checked
                want = {k: w for k, w in want.items()
                        if not k.startswith("block_pcg")}
            div = check3d_run(prob, out, c, want, f"wake3d_path {name} r{r}")
            outs[name, r] = out["v"]
            launches[name, r] = c
            runs[f"{name}_refine{r}"] = dict(divergence=div, seconds=s,
                                             launches=c, **route_info(out))
    rerun, c, s = nse3d(prob, dev, warm_refine=1, ops=ops["element"],
                        banded=False, **ini)
    shares = {f"{name}_refine{r}": step_share(
        prob, dev, ops[name], ini, r,
        {} if name == "banded" else dict(banded=False))
        for name in ("banded", "element") for r in (0, 1)}
    routes = rel(outs["element", 1], outs["banded", 1])
    r01 = {name: rel(outs[name, 0], outs[name, 1])
           for name in ("banded", "element")}
    say(phase="wake3d_path_runs", runs=runs, routes_rel_refine1=routes,
        refine0_vs_1=r01, F_band_gb=band_gb, step_share=shares)
    require(torch.equal(rerun["v"], outs["element", 1]),
            "wake3d_path: the element route's rerun differs in its bits")
    require(routes <= 1e-6, f"wake3d_path: the two routes at refine 1 differ "
            f"by {routes:.3e} > 1e-6")
    require(max(r01.values()) <= 1e-4, f"wake3d_path: refine 0 vs 1 {r01}")
    chk = kernels3d(prob, ops["element"].solver, ops["banded"].solver,
                    f"wake3d nz={NZ_PATH}", gen, timed=True)
    say(phase="wake3d_path", problem=f"3D-2Z nz={NZ_PATH}",
        nv_full=prob.nv_full, nin=len(prob.invinds), np=prob.np_cond,
        tets=prob.space.mesh.num_cells, F_band_gb=band_gb,
        build_seconds=build_s, stokes_seconds=stokes_s,
        routes_rel_refine1=routes, refine0_vs_1=r01,
        element_rerun_bitwise=True, runs=runs,
        checks={k: [{kk: vv for kk, vv in c_.items() if kk != "plan"}
                    for c_ in v] for k, v in chk.items()})
    return chk, launches, ops


def rows3d(chk, launches, ops):
    """The ``kernels`` line's rows of this slice's forms: K1 (fused and
    vector), K2 (per mode), K3 (F, J, J^T), B7 (vector and block), with
    the launches of the nz=8 routes at refine 1 (the block form: the
    banded route's device setup)."""
    le, lb = launches["element", 1], launches["banded", 1]
    setup = launches["banded", 0]
    rows = []
    for form, name, n in (("amatvec_sym_True", "convection_3d",
                           le["conv_vector_amatvec"]),
                          ("vector", "convection_vector_3d",
                           lb["conv_vector"])):
        c = next(c for c in chk["conv"] if c["form"] == form and "ms" in c)
        rows.append(dict(
            name=name, route="cuda",
            source="dolfin_navier_scipy_tpu_torch/csrc/convection.cu",
            replaces="tools/probe_pallas_gather.py:14", launches=n,
            shape=dict(nc=c["nc"], nv_full=c["nv_full"],
                       facet_blocks=c["facet_blocks"], tables=c["tables"],
                       state=c["state"]),
            max_abs_err=c["max_abs_err"], ms=c["ms"], plain_ms=c["plain_ms"],
            bound_ms=c["bound_ms"], bound_by=c["bound_by"], library_ms=None,
            eager_ms=c["eager_ms"],
            device_kernels_per_call=c.get("device_kernels_per_call"),
            design=CONV3D_DESIGN))
    for r in affine_rows(chk["affine"], "_3d", dict(
            le["affine_modes"], res=le["affine_residual"])):
        r["design"] = AFFINE3D_DESIGN
        rows.append(r)
    for c, n in zip(chk["elem"], (le["elem_mv"], 0, 0)):
        row = dict(elem_row(c, n), name="elem_mv_3d"
                   + ("" if "F =" in c["operand"] else
                      "_jt" if c["transpose"] else "_j"))
        if c["plan"]["staged"]:
            row["design"] = ELEM30_DESIGN
        rows.append(row)
    for c, n, kind in zip(chk["pcg"], (le["pcg_step"],
                                       setup["block_pcg_step"]),
                          ("vector", "block")):
        rows.append(dict(
            name=c["name"], route="cuda",
            source="dolfin_navier_scipy_tpu_torch/csrc/pcg.cu",
            replaces=PCG_REPLACES[kind], launches=n, operand=c["operand"],
            shape=dict(n=c["n"], k=c["k"], dtype=c["dtype"]),
            max_abs_err=c["max_abs_err"], ms=c["ms"], plain_ms=c["plain_ms"],
            bound_ms=c["bound_ms"], bound_by=c["bound_by"], library_ms=None,
            eager_ms=c["eager_ms"],
            device_kernels_per_call=c["device_kernels_per_call"],
            design=PCG_DESIGN))
    return rows


def main():
    t_start = time.time()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say(phase="versions", python=sys.version.split()[0],
        torch=torch.__version__, cuda=torch.version.cuda,
        sm_count=torch.cuda.get_device_properties(0).multi_processor_count)

    # -- 1. build every kernel from the sources in this checkout ----------
    t0 = time.time()
    logs = kernels.build_all(extra_flags=("-Xptxas", "-v"))
    say(phase="build", seconds=time.time() - t0, sources=sorted(logs),
        build_dir=kernels.build_dir(),
        ptxas=[ln for log in logs.values() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln][:24])

    # -- 2. the kernel against its plain version, on the card -------------
    prob = cylinderwake_problem(level=LEVEL, Re=RE, charvel=CHARVEL)
    n_main = prob.nv_full + prob.np_cond       # the padded inverse's side
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    checks = []
    # the two main-path shapes (CNAB full layout: rows padded by 2 columns;
    # sbdf2 inner layout: 16-byte rows already) and a ragged one, f32 and
    # f64, each in the padded storage the kernel streams
    n_inner = len(prob.invinds) + prob.np_cond
    for (m, n), dt, reps in (((n_main, n_main), torch.float32, 50),
                             ((n_inner, n_inner), torch.float32, 50),
                             (RAGGED, torch.float32, 200),
                             (RAGGED, torch.float64, 200)):
        KT = as_vecmat_operand(torch.randn((m, n), generator=gen, dtype=dt),
                               device=dev)
        x = torch.randn(m, generator=gen, dtype=dt).to(dev)
        checks.append(check_vecmat(x, KT, "random", reps,
                                   counted=len(checks) < 2))
        del KT, x
    # the convection kernel on the level-1 tables: f32 tables under the f64
    # state (what the loop runs) and under an f32 state, f64 tables, and a
    # permuted dof map with re-indexed facet blocks
    nv = prob.nv_full
    sym_main = bool(prob.gradvsymmtrc)
    u64, v64 = (torch.randn(nv, generator=gen, dtype=torch.float64).to(dev)
                for _ in range(2))
    conv_checks = []
    affs = {}
    for wdt, udt, timed in ((torch.float32, torch.float64, True),
                            (torch.float32, torch.float32, False),
                            (torch.float64, torch.float64, True)):
        if wdt not in affs:
            affs[wdt] = AffineVectorOps.build(prob, wdt, full_dofs=True)
        conv_checks += check_conv(
            prob.conv_kernel_on(wdt), affs[wdt], affs[wdt].fac_dofs,
            u64.to(udt), v64.to(udt), "random", sym_main, timed,
            counted=not conv_checks)
    perm = torch.randperm(nv, generator=gen)
    dofmap = torch.cat([perm, torch.tensor([nv])]).to(dev)
    aff32 = affs[torch.float32]
    conv_checks += check_conv(
        prob.conv_kernel_on(torch.float32).with_dof_map(dofmap), aff32,
        aff32.fac_dofs.with_dof_map(dofmap),
        torch.empty_like(u64).index_copy_(0, dofmap[:nv], u64),
        torch.empty_like(v64).index_copy_(0, dofmap[:nv], v64),
        "random, permuted dof map", sym_main, False)
    require(aff32.fac_elem.shape[0] > 0, "the wake has outflow facet blocks")
    # the banded kernels on the operands of the default route's solver (the
    # same dt, so the same blocks as the schur_path runs below), checked
    # here: before any CPU run
    dt_main = (TE - T0) / NTS
    t0 = time.time()
    sops = _build_ops(prob, dt_main, theta=0.5, linsolver="schur",
                      layout="full", device=dev)
    torch.cuda.synchronize()
    schur_build_s = time.time() - t0
    slv = sops.solver
    band_checks = check_band(band_forms(slv, gen))
    stack_checks, picked1 = check_stack_forms(slv, gen)
    band_edges = check_band_edges(band_edge_forms(slv, gen))
    # the affine kernel on the level-1 tables: f32 under the vectors the
    # paths give it (timed), over the full dof set, and f64
    aff_checks = check_affine(prob.affine_ops(torch.float32, device=dev),
                              prob, False, "level 1", gen,
                              timed=AFFINE_STATE, counted=True, chunks=True)
    aff_checks += check_affine(affs[torch.float32], prob, True,
                               "level 1, full dofs", gen)
    # J v of the continuity rhs: f64 tables under the f64 carry
    aff_checks += check_affine(prob.affine_ops(torch.float64, device=dev),
                               prob, False, "level 1, f64 tables", gen,
                               timed=dict(j=torch.float64))
    say(phase="kernel_checks", vecmat=checks, convection=conv_checks,
        banded=band_checks, banded_edges=band_edges,
        level_stack_forms=stack_checks, stack_plan_picks=picked1,
        affine=aff_checks, schur_solver_build_seconds=schur_build_s)
    del sops, slv
    # the discrete adjoint (traced here: before the long CPU runs)
    adj_rows = adjoint_path(dev, gen)
    elem_checks = elemmv_checks(dev, gen)
    device_setup_path(prob, dev, dt_main)
    # the control slice at level 2 (traced here: before any CPU run)
    nsteps = NTS - 1          # the Heun bootstrap takes the first interval
    aff_checks2, control2_modes = control_level2(dev, gen, nsteps)
    # the steady slice: the matrix-free route at level 2 (its FGMRES
    # cycle traced here, before the CPU runs), the dense route and the
    # pseudo-time march at level 1
    elem_launches2 = steady_krylov_level2(dev)
    torch.cuda.empty_cache()
    dfg1, v_newton, _ = steady_dense_path(dev)
    pseudotime_path(dfg1, v_newton)
    newton_ti_path(dev, dfg1, v_newton)
    del dfg1
    torch.cuda.empty_cache()

    # -- 3. the main path, through the user's entry points -----------------
    kw = dict(t0=T0, tE=TE, Nts=NTS, start_ssstokes=True,
              time_int_scheme="cnab", linsolver="dense",
              save_every=SAVE_EVERY)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.time()
    out = solve_nse(prob=prob, **kw)           # device=None: the card
    torch.cuda.synchronize()
    wall = time.time() - t0
    main_counts = counts()
    launches = main_counts["vecmat"]

    nin, npc = len(prob.invinds), prob.np_cond
    nsaved = nsteps // SAVE_EVERY
    v, p = out["v"], out["p"]
    require(v.is_cuda and out["carry"]["v"].is_cuda, "the loop left the card")
    require(v.dtype == torch.float64
            and out["ops"].wdtype == torch.float32, "f32 work / f64 carry")
    require(tuple(v.shape) == (nin,) and tuple(p.shape) == (npc,)
            and tuple(out["vs"].shape) == (nsaved, nin)
            and tuple(out["ps"].shape) == (nsaved, npc), "output shapes")
    require(out["ffflag"] is False, "blow-up flag set")
    for k in ("v", "p", "vs", "ps"):
        require(bool(torch.isfinite(out[k]).all()), f"{k} not finite")
    # one dense apply per loop step and none in the setup (the Stokes
    # start, the pressure recovery and the Heun bootstrap are host splu)
    # likewise one fused convection launch per loop step; the plain
    # convection vector three times in the Heun bootstrap and once for the
    # AB2 start value (the Stokes start brings its own pressure)
    require(main_counts == dict(vecmat=nsteps, conv_vector=4,
                                conv_vector_amatvec=nsteps, affine_mv=0,
                                affine_residual=0, elem_mv=0,
                                **NONE_BANDED),
            f"launches on the main path: {main_counts}")
    div_rel = divergence_rel(prob, v)
    # each f32 increment solve leaves a divergence residual of f32 size
    # relative to |J||delta|; 300 of them stay far below 1e-6 of |J||v|
    require(div_rel <= 1e-6, f"divergence residual {div_rel:.3e}")
    loop_s = out["timing"]["loop_s"]
    say(phase="main_path", problem="cylinderwake level 1, Re 100",
        nv_full=prob.nv_full, nin=nin, np_cond=npc,
        cells=int(prob.space.mesh.num_cells), steps=nsteps,
        launches=main_counts, vecmat_shape=[n_main, n_main],
        wall_seconds=wall, setup_seconds=out["timing"]["setup_s"],
        bootstrap_seconds=out["timing"]["bootstrap_s"],
        loop_seconds=loop_s, steps_per_s=nsteps / loop_s,
        ms_per_step=1e3 * loop_s / nsteps,
        divergence_residual_rel=div_rel,
        peak_device_mem_bytes=torch.cuda.max_memory_allocated())

    # the same call again, warm (the first loop pays one-off library
    # start-up inside its timing): the loop's rate to quote
    zero_counts()
    warm = solve_nse(prob=prob, **kw)
    require(counts() == main_counts, "launch counts of the warm run")
    wl = warm["timing"]["loop_s"]
    # no atomic adds anywhere in the loop: two runs give the same bits
    rel_diff = rel(warm["v"], v)
    require(rel_diff == 0.0 and torch.equal(warm["v"], v)
            and torch.equal(warm["p"], p),
            f"two runs on the card differ: {rel_diff:.3e}")
    say(phase="main_path_warm", steps=nsteps, loop_seconds=wl,
        steps_per_s=nsteps / wl, ms_per_step=1e3 * wl / nsteps,
        setup_seconds=warm["timing"]["setup_s"],
        bootstrap_seconds=warm["timing"]["bootstrap_s"],
        rel_diff_v_to_first_run=rel_diff)
    del warm

    # the kernel once more on the operands of that run: the padded inverse
    # and a right-hand side of the size the loop feeds it
    fl = next(iter(prob._full_layouts.values()))
    x_run = torch.zeros(n_main, dtype=torch.float32, device=dev)
    mv = prob.full["M"] @ prob.embed(v).cpu().numpy()
    x_run[: prob.nv_full] = torch.as_tensor(mv.astype(np.float32),
                                            device=dev)
    run_check = check_vecmat(x_run, fl["ZpT"], "inverse of the run", 50)
    run_conv = check_conv(
        prob.conv_kernel_on(torch.float32), aff32, aff32.fac_dofs,
        out["carry"]["v"], prob.embed(out["bootstrap"]["v"]),
        "state of the run", sym_main, True)
    say(phase="kernel_check_run_operands", vecmat=run_check,
        convection=run_conv)

    # -- 4. the same call on the CPU in f64 ---------------------------------
    before = counts()
    t0 = time.time()
    ref = solve_nse(prob=prob, device="cpu", **kw)
    cpu_s = time.time() - t0
    require(counts() == before, "the CPU run launched a kernel")
    require(ref["ffflag"] is False, "blow-up flag set in the CPU run")

    errs = {k: rel(out[k], ref[k]) for k in ("v", "p", "vs", "ps")}
    # f32 increment solves under an f64 carry: the velocity holds 1e-6
    require(errs["v"] <= 1e-6 and errs["vs"] <= 1e-6,
            f"card vs CPU f64: {errs}")
    say(phase="reference", device="cpu f64", seconds=cpu_s,
        cpu_steps_per_s=nsteps / ref["timing"]["loop_s"], rel_err=errs)
    krylov_cnab(prob, kw, ref, nsteps)

    # -- 5. the rest of the DFG benchmark run, on the same problem ----------
    trange = np.linspace(T0, TE, NTS + 1)
    half = NTS // 2
    skw = dict(kw, time_int_scheme="sbdf2")
    zero_counts()
    sb = solve_nse(prob=prob, **skw)
    sb_counts = counts()
    sb_modes = dict(affine_mv.mode_launches)
    require(sb_modes == dict(m=nsteps, a=nsteps, ma=0, j=nsteps, jt=0),
            f"affine launches of the sbdf2 run by mode: {sb_modes}")
    # inner layout with f32 work: the dense apply and one refinement round
    # a step; one convection vector a step and three in the Heun bootstrap;
    # the affine kernel for M dv, A v and the continuity rhs (J v, f64),
    # its fused form for the round's residual (K v + J^T q, J v)
    require(sb_counts == dict(vecmat=2 * nsteps, conv_vector=nsteps + 3,
                              conv_vector_amatvec=0, affine_mv=3 * nsteps,
                              affine_residual=nsteps, elem_mv=0,
                              **NONE_BANDED),
            f"launches of the sbdf2 run: {sb_counts}")
    require(sb["ffflag"] is False and sb["v"].is_cuda, "sbdf2 run")
    # the inner layout gives the dense kernel another operand: the unpadded
    # inverse over the inner and pressure dofs, under a right-hand side of
    # that run's size (the mass matrix times its final state)
    KinvT = sb["ops"].solver.KinvT
    require(tuple(KinvT.shape) == (n_inner, n_inner) and KinvT.is_cuda
            and KinvT.dtype == torch.float32, "inverse of the sbdf2 run")
    x_sb = torch.zeros(n_inner, dtype=torch.float32, device=dev)
    x_sb[:nin] = torch.as_tensor(
        (prob.Mc @ sb["v"].cpu().numpy()).astype(np.float32), device=dev)
    sb_check = check_vecmat(x_sb, KinvT, "inverse of the sbdf2 run", 50)
    # the same horizon as two halves: the carry continues the BDF2
    # recursion exactly, and nothing in the loop adds atomically
    zero_counts()
    first = sbdf2(trange=trange[: half + 1], prob=prob, inivel=sb["iniv"],
                  ops=sb["ops"], save_every=SAVE_EVERY)
    second = sbdf2(trange=trange[half:], prob=prob, ops=sb["ops"],
                   resume_carry=first["carry"], save_every=SAVE_EVERY)
    require(counts() == sb_counts, f"launches of the two halves: {counts()}")
    require(second["bootstrap"] is None, "the resumed half re-bootstrapped")
    require(torch.equal(second["v"], sb["v"])
            and torch.equal(second["p"], sb["p"]),
            "split-and-resumed sbdf2 differs from the unsplit run: "
            f"{rel(second['v'], sb['v']):.3e}")
    t0 = time.time()
    sb_ref = solve_nse(prob=prob, device="cpu", **skw)
    sb_cpu_s = time.time() - t0
    sb_errs = {k: rel(sb[k], sb_ref[k]) for k in ("v", "p", "vs", "ps")}
    require(sb_errs["v"] <= 1e-6 and sb_errs["vs"] <= 1e-6,
            f"sbdf2, card vs CPU f64: {sb_errs}")

    # CNAB with the in-loop lift/drag/pressure-drop series
    dt = float(trange[1] - trange[0])
    outfunc, ob = make_inscan_liftdrag(prob, dt, charvel=CHARVEL)
    zero_counts()
    ld = solve_nse(prob=prob, outfunc=outfunc, out_bundle=ob, **kw)
    require(counts() == main_counts, f"launches with the hook: {counts()}")
    outs = ld["outs"]
    require(tuple(outs.shape) == (nsteps, 3) and outs.is_cuda
            and bool(torch.isfinite(outs).all()), "in-loop series")
    # the hook reads the carry and changes nothing of the trajectory
    require(torch.equal(ld["v"], v), "the in-loop hook changed the run")
    of_cpu, ob_cpu = make_inscan_liftdrag(prob, dt, charvel=CHARVEL,
                                          device="cpu")
    t0 = time.time()
    ld_ref = solve_nse(prob=prob, device="cpu", outfunc=of_cpu,
                       out_bundle=ob_cpu, **kw)
    ld_cpu_s = time.time() - t0
    last, last_ref = outs[-1].cpu().double(), ld_ref["outs"][-1].double()
    # f32 sums of ~1e3 terms on both sides, over different trajectories
    # (f32 work vs f64): relative to the row's largest entry
    last_err = float((last - last_ref).abs().max() / last_ref.abs().max())
    require(last_err <= 1e-4, f"in-loop [Cl, Cd, dp] vs CPU: {last_err:.3e}")
    require(rel(ld["v"], ld_ref["v"]) <= 1e-6, "cnab+hook, card vs CPU f64")
    say(phase="dfg_path", problem="cylinderwake level 1, Re 100",
        steps=nsteps, sbdf2_launches=sb_counts, sbdf2_vecmat=sb_check,
        sbdf2_loop_seconds=sb["timing"]["loop_s"],
        sbdf2_ms_per_step=1e3 * sb["timing"]["loop_s"] / nsteps,
        sbdf2_split_at=half, sbdf2_split_equal=True,
        sbdf2_rel_err_vs_cpu_f64=sb_errs, sbdf2_cpu_seconds=sb_cpu_s,
        cnab_liftdrag_launches=main_counts,
        cnab_liftdrag_loop_seconds=ld["timing"]["loop_s"],
        cnab_liftdrag_ms_per_step=1e3 * ld["timing"]["loop_s"] / nsteps,
        cl_cd_dp_last=[float(x) for x in last],
        cl_cd_dp_last_cpu_f64=[float(x) for x in last_ref],
        cl_cd_dp_last_rel_err=last_err,
        cnab_liftdrag_rel_err_v_vs_cpu_f64=rel(ld["v"], ld_ref["v"]),
        cnab_liftdrag_cpu_seconds=ld_cpu_s)

    # -- 6. the user's default call: banded block-Schur, w-space ------------
    dkw = dict(t0=T0, tE=TE, Nts=NTS, start_ssstokes=True,
               save_every=SAVE_EVERY)          # no linsolver: 'auto'
    schur = {}
    for wr in (0, 1):
        zero_counts()
        t0 = time.time()
        o = solve_nse(prob=prob, warm_refine=wr, **dkw)
        torch.cuda.synchronize()
        schur[wr] = (o, counts(), time.time() - t0,
                     dict(rect_mv_levels.kernel_launches),
                     dict(rect_mv_levels.stack_launches))
    o0, c0 = schur[0][:2]
    slv = o0["ops"].solver
    # the launches of each level stack in the refine-0 run, for the table
    stack_launches1 = {
        label: schur[0][4][tuple(t.shape)] for label, t in (
            ("W, 3 bf16 levels", slv.Wb), ("X, 2 bf16 levels", slv.Xb),
            ("S^-1, 3 bf16 levels", slv.Sinv))}
    require(isinstance(slv, SchurSaddleSolver)
            and hasattr(o0["ops"], "full_schur"), "the default route at "
            "8016 rows is the banded block-Schur solver, full layout")
    for name, levels in (("Wb", 3), ("Xb", 2), ("Sinv", 3)):
        st = getattr(slv, name)
        require(st is not None and st.is_cuda and st.dtype == torch.bfloat16
                and st.shape[1] == levels,
                f"{name}: {levels} bf16 levels on the card")
    require(tuple(o0["carry"]["v"].shape) == (prob.nv_full,)
            and "ysol" in o0["carry"], "w-space carry")
    # the kernel each single-level product of the step runs on: J's 8 row
    # blocks are too few for the warp-per-row grid, so J takes the ring
    operand_kernels = {op: band_kernel(name, B) for op, name, B in (
        ("E", "banded_mv", slv.Eblk), ("F", "banded_mv", slv.Bblk),
        ("J", "rect_mv", slv.Jb), ("J^T", "rect_mv", slv.JTb))}
    require(operand_kernels["J"] == "ring", "at level 1 J runs on the "
            f"bulk-copy ring kernel: {operand_kernels}")
    operand_kernels.update((op, picked1[label]) for op, label in (
        ("W", "W, 3 bf16 levels"), ("W level 0", "W, 3 bf16 levels, hi_only"),
        ("X", "X, 2 bf16 levels"), ("S^-1", "S^-1, 3 bf16 levels")))
    for wr, (o, c, _, by_form, by_shape) in schur.items():
        # a loop step: one convection vector, the banded A, the solve (W,
        # J, S^-1, X) and per refine round the residual (F, J^T, J) and a
        # second solve; the start: 3 Heun bootstrap vectors and the AB2
        # start value; the setup: none (host splu, W built by torch.bmm)
        want = dict(vecmat=0, conv_vector=nsteps + 4, conv_vector_amatvec=0,
                    banded_mv=nsteps * (1 + wr),
                    rect_mv=nsteps * (1 + 3 * wr),
                    rect_mv_levels=nsteps * 3 * (1 + wr), affine_mv=0,
                    affine_residual=0,
                elem_mv=0)
        require(c == want, f"launches of the Schur run, warm_refine={wr}: "
                f"{c} != {want}")
        # each level stack on the kernel form its plan picks
        want_shape, want_form = stack_counts_want(slv, picked1, nsteps, wr)
        require(by_shape == want_shape and by_form == want_form,
                f"rect_mv_levels launches of the Schur run, warm_refine="
                f"{wr}: by stack {by_shape} != {want_shape}, by kernel form "
                f"{by_form} != {want_form}")
        require(o["ffflag"] is False and o["v"].is_cuda
                and o["v"].dtype == torch.float64, "Schur run")
        for k in ("v", "p", "vs", "ps"):
            require(bool(torch.isfinite(o[k]).all()), f"{k} not finite")
    zero_counts()
    again = solve_nse(prob=prob, warm_refine=0, **dkw)
    require(counts() == c0, "launches of the Schur rerun")
    rerun_diff = rel(again["v"], o0["v"])
    require(rerun_diff == 0.0 and torch.equal(again["v"], o0["v"])
            and torch.equal(again["p"], o0["p"]),
            f"two Schur runs on the card differ: {rerun_diff:.3e}")
    del again
    schur_rows = {}
    for wr, (o, c, wall_s, by_form, _) in schur.items():
        div_rel = divergence_rel(prob, o["v"])
        require(div_rel <= 1e-6, f"Schur run, warm_refine={wr}: divergence "
                f"residual {div_rel:.3e}")
        e = {k: rel(o[k], ref[k]) for k in ("v", "p", "vs", "ps")}
        # one refine round against the exact banded F holds the f32 floor;
        # unrefined, W's 3e-3 truncation leaves its imprint on the
        # increments (the JAX package's record: 8.9e-6 to 3.8e-5)
        bar = 1e-6 if wr else 1e-4
        require(e["v"] <= bar and e["vs"] <= bar,
                f"Schur run, warm_refine={wr}, card vs CPU f64: {e}")
        t = o["timing"]
        schur_rows[wr] = dict(
            launches=c, rect_mv_levels_by_form=by_form,
            wall_seconds=wall_s, setup_seconds=t["setup_s"],
            bootstrap_seconds=t["bootstrap_s"], loop_seconds=t["loop_s"],
            steps_per_s=nsteps / t["loop_s"],
            ms_per_step=1e3 * t["loop_s"] / nsteps,
            divergence_residual_rel=div_rel, rel_err_vs_cpu_f64=e,
            bar=bar)
    # sbdf2 on the same route (inner layout: the solve unrefined, as in the
    # JAX package), against its CPU f64 run of step 5
    zero_counts()
    sbs = solve_nse(prob=prob, **dict(skw, linsolver="schur"))
    sbs_counts = counts()
    want = dict(vecmat=0, conv_vector=nsteps + 3, conv_vector_amatvec=0,
                banded_mv=0, rect_mv=nsteps, rect_mv_levels=3 * nsteps,
                affine_mv=3 * nsteps, affine_residual=0,
                elem_mv=0)
    require(sbs_counts == want, f"launches of the Schur sbdf2 run: "
            f"{sbs_counts} != {want}")
    require(isinstance(sbs["ops"].solver, SchurSaddleSolver)
            and sbs["ffflag"] is False, "Schur sbdf2 run")
    sbs_errs = {k: rel(sbs[k], sb_ref[k]) for k in ("v", "p", "vs", "ps")}
    require(sbs_errs["v"] <= 1e-4 and sbs_errs["vs"] <= 1e-4,
            f"Schur sbdf2, card vs CPU f64: {sbs_errs}")
    say(phase="schur_path", problem="cylinderwake level 1, Re 100",
        call="solve_nse(prob, t0, tE, Nts=300, start_ssstokes=True, "
             "save_every=60, warm_refine=0|1)",
        steps=nsteps, solver=dict(
            bs=slv._bs, nblk=slv._nblk, ww=slv._ww, wx=slv._wx, ncg=slv.ncg,
            Wb=list(slv.Wb.shape), Xb=list(slv.Xb.shape),
            Sinv=list(slv.Sinv.shape), Jb=list(slv.Jb.shape),
            JTb=list(slv.JTb.shape), Eblk=list(slv.Eblk.shape)),
        warm_refine_0=schur_rows[0], warm_refine_1=schur_rows[1],
        rel_diff_v_to_first_run=rerun_diff, operand_kernels=operand_kernels,
        sbdf2=dict(launches=sbs_counts, bar=1e-4,
                   loop_seconds=sbs["timing"]["loop_s"],
                   setup_seconds=sbs["timing"]["setup_s"],
                   ms_per_step=1e3 * sbs["timing"]["loop_s"] / nsteps,
                   rel_err_vs_cpu_f64=sbs_errs))
    del sbs, schur, o0, slv

    # -- the checkpoint store: sections, resume, PVD series, Timer trace --
    checkpoint_path(dev)

    # -- the banded convection tail (B6), forced, against B5 and CPU f64 ----
    tail_checks, tail_counts = banded_conv_path(dev, gen, nsteps, ref)

    # -- 7. the control slice at level 1, against CPU f64 ------------------
    control_modes = control_path(dev, gen, nsteps)

    # -- 8. the default call at level 2: the factors built on the card -------
    res_launches2, level2_rows = level2_path(dev, gen, nsteps)

    # -- 9. 3D: the Schaefer-Turek 3D-2Z wake, both block-Schur routes -----
    wake3d_small(dev, gen)
    chk3d, launches3d, ops3d = wake3d_path(dev, gen)

    # -- the kernels table and the verdict ----------------------------------
    main_chk = checks[0]

    def band_row(name, operand, launches):
        chk = next(c for c in band_checks
                   if c["name"] == name and c["operand"] == operand)
        return dict(
            name=name + STACK_ROWS.get(operand, ""), route="cuda",
            source="dolfin_navier_scipy_tpu_torch/csrc/bandmv.cu",
            replaces=(SAPPLY if operand.startswith("S^-1")
                      else BAND_REPLACES[name]),
            launches=launches, operand=operand,
            shape=chk["shape"], max_abs_err=chk["max_abs_err"],
            ms=chk["ms"], plain_ms=chk["plain_ms"],
            bound_ms=chk["bound_ms"], bound_by=chk["bound_by"],
            library_ms=chk["library_ms"],
                    library_eager_ms=chk.get("library_eager_ms"), library=chk["library"],
            eager_ms=chk["eager_ms"],
            device_kernels_per_call=chk["device_kernels_per_call"],
            kernel=chk["kernel"], design=BAND_DESIGN[chk["kernel"]])

    def conv_row(name, form, launches):
        chk = next(c for c in conv_checks
                   if c["form"] == form and "ms" in c
                   and c["tables"] == "torch.float32")
        return dict(
            name=name, route="cuda",
            source="dolfin_navier_scipy_tpu_torch/csrc/convection.cu",
            replaces="tools/probe_pallas_gather.py:14", launches=launches,
            shape=dict(nc=chk["nc"], nv_full=chk["nv_full"],
                       facet_blocks=chk["facet_blocks"],
                       tables=chk["tables"], state=chk["state"]),
            max_abs_err=chk["max_abs_err"], ms=chk["ms"],
            plain_ms=chk["plain_ms"], bound_ms=chk["bound_ms"],
            bound_by=chk["bound_by"],
            # no single PyTorch call computes gather -> quadrature ->
            # scatter; the plain version is ~45 of them
            library_ms=None, eager_ms=chk["eager_ms"],
            device_kernels_per_call=chk["device_kernels_per_call"],
            design=DESIGN)

    def tail_row(chk, launches):
        return dict(
            name="conv_tail", route="cuda",
            source="dolfin_navier_scipy_tpu_torch/csrc/convection.cu",
            replaces=TAIL_REPLACES, launches=launches,
            shape=dict(nc=chk["nc"], nin=chk["nin"], nvals=chk["nvals"],
                       slot_width=chk["slot_width"]),
            max_abs_err=chk["max_abs_err"], ms=chk["ms"],
            plain_ms=chk["plain_ms"], bound_ms=chk["bound_ms"],
            bound_by=chk["bound_by"],
            # no single PyTorch call computes the tail; its two 0/1
            # products' calls (index_select, cuSPARSE) are summed beside
            library_ms=None, library_parts_ms=chk["library_parts_ms"],
            library_sum_ms=chk["library_sum_ms"], library=chk["library"],
            b5_ms=chk["b5_ms"], eager_ms=chk["eager_ms"],
            device_kernels_per_call=chk["device_kernels_per_call"])

    say(phase="done", total_seconds=time.time() - t_start)
    print(smi, flush=True)
    say(kernels=[
        dict(name="vecmat", route="cuda",
             source="dolfin_navier_scipy_tpu_torch/csrc/vecmat.cu",
             replaces="dolfin_navier_scipy_tpu/ops/pallas_kernels.py:31",
             launches=launches, shape=main_chk["shape"],
             max_abs_err=main_chk["max_abs_err"], ms=main_chk["ms"],
             plain_ms=main_chk["plain_ms"], bound_ms=main_chk["bound_ms"],
             bound_by=main_chk["bound_by"],
             library_ms=main_chk["library_ms"],
             library_eager_ms=main_chk.get("library_eager_ms"),
             eager_ms=main_chk["eager_ms"],
             device_kernels_per_call=main_chk["device_kernels_per_call"],
             design=DESIGN),
        # the same kernel at the shape the sbdf2 run gives it
        dict(name="vecmat_inner_layout", route="cuda",
             source="dolfin_navier_scipy_tpu_torch/csrc/vecmat.cu",
             replaces="dolfin_navier_scipy_tpu/ops/pallas_kernels.py:31",
             launches=sb_counts["vecmat"], shape=sb_check["shape"],
             max_abs_err=sb_check["max_abs_err"], ms=sb_check["ms"],
             plain_ms=sb_check["plain_ms"], bound_ms=sb_check["bound_ms"],
             bound_by=sb_check["bound_by"],
             library_ms=sb_check["library_ms"],
             eager_ms=sb_check["eager_ms"],
             # counted on the random operand of the same shape
             device_kernels_per_call=checks[1]["device_kernels_per_call"],
             device_kernels_operand=(f'{checks[1]["operand"]} '
                                     f'{checks[1]["shape"]}'),
             design=DESIGN),
        conv_row("convection", f"amatvec_sym_{sym_main}",
                 main_counts["conv_vector_amatvec"]),
        conv_row("convection_vector", "vector",
                 main_counts["conv_vector"]),
        # the banded kernels, with the launches of the default call
        # (warm_refine=0) and their largest operand on that route
        band_row("banded_mv", "E band (explicit A)", c0["banded_mv"]),
        band_row("rect_mv", "J", c0["rect_mv"]),
        # the level stacks, each with its launches in that call
        *(band_row("rect_mv_levels", label, n)
          for label, n in stack_launches1.items()),
        # the same kernels on the level-2 operands, launches of that path
        *level2_rows,
        # the affine kernel: A v of the controlled step (control_path (a)),
        # M dv of its sbdf2 (d), J v of the continuity rhs (f64 tables) and
        # the fused residual of the dense sbdf2 run of the DFG path; A v and
        # the residual at level 2 (control_level2 (a), the dense route)
        *affine_rows([c for c in aff_checks if not (
            c["mode"] == "j" and c["tables"] == "torch.float32")], "", dict(
                a=control_modes["a"]["a"], m=control_modes["d"]["m"],
                j=sb_modes["j"], res=sb_counts["affine_residual"])),
        *affine_rows(aff_checks2, "_level2", dict(
            a=control2_modes["a"], res=res_launches2)),
        # the element-matrix matvec on the steady route's level-2 operand,
        # with the launches of the matrix-free steady solve there
        elem_row(next(c for c in elem_checks
                      if c["operand"] == "_sk_elem32, level 2"),
                 elem_launches2),
        # the banded convection tail in one launch (level 1), with the
        # launches of the forced default call
        tail_row(tail_checks[LEVEL], tail_counts["conv_tail"]),
        # the backward kernels of the adjoint, with the launches of one
        # gradient (level 1: the example's, in the schedule; level 2: in
        # the initial state)
        *adjoint_rows(adj_rows),
        # this slice's forms: K1-K4 on the 3D-2Z nz=8 operands, with the
        # launches of its two routes (refine 1; B7's block form: the
        # banded route's device setup)
        *rows3d(chk3d, launches3d, ops3d)])
    say(ok=True, device=dict(platform="gpu",
                             kind=torch.cuda.get_device_name(0),
                             count=torch.cuda.device_count()))


if __name__ == "__main__":
    main()
