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
   bits, and no hand-written kernel runs during a setup,
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

Every phase prints one JSON line; any failed phase raises, so the exit
code is non-zero and the final line is missing.  The last line is
``{"ok": true, "device": {...}}``, the one before it the ``kernels`` table.
"""

import contextlib
import copy
import ctypes
import hashlib
import itertools
import json
import math
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
    LiftDragSurfForce, cylinderwake_problem, make_inscan_liftdrag,
    observation_operator, pressure_drop)
from dolfin_navier_scipy_tpu_torch.ops import banded_conv, kernels
from dolfin_navier_scipy_tpu_torch.ops.affine import AffineVectorOps
from dolfin_navier_scipy_tpu_torch.ops.banded_conv import (
    banded_stream_us, banded_wins, build_banded_conv_tail, gate_constants,
    index_pipeline_us, tail_patterns)
from dolfin_navier_scipy_tpu_torch.ops.elementop import build_element_ops
from dolfin_navier_scipy_tpu_torch.ops.kernels import (
    _affine_launch, _windows, affine_mv, affine_mv_ref, affine_residual,
    affine_residual_ref, as_band_operand, as_vecmat_operand,
    banded_mv, banded_mv_ref, conv_quad, conv_quad_ref, conv_vector,
    conv_vector_amatvec, conv_vector_amatvec_ref, conv_vector_ref, elem_mv,
    elem_mv_ref, rect_mv,
    rect_mv_levels, rect_mv_levels_ref, rect_mv_ref, vecmat, vecmat_ref)
from dolfin_navier_scipy_tpu_torch.solve import (
    DirichletControl, KrylovSaddleSolver, SchurSaddleSolver, sbdf2,
    solve_nse, solve_nse_newton_ti, solve_sadpnt_host, solve_steadystate_nse,
    solve_steadystate_pseudotime, steady)
from dolfin_navier_scipy_tpu_torch.solve.newton_ti import _make_bundle, _sweep
from dolfin_navier_scipy_tpu_torch.solve.steady import (
    SteadyKrylovKernel, _sk_elem32)
from dolfin_navier_scipy_tpu_torch.solve.timeint import _build_ops

# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate
# and the f32 / f64 rates outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12
WRAPPERS = (vecmat, conv_vector, conv_vector_amatvec, banded_mv, rect_mv,
            rect_mv_levels, affine_mv, affine_residual, elem_mv)
NONE_BANDED = dict(banded_mv=0, rect_mv=0, rect_mv_levels=0)

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
    for w in WRAPPERS:
        w.launches = 0
    conv_quad.launches = 0
    rect_mv.storage_launches = dict.fromkeys(rect_mv.storage_launches, 0)
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
               library_ms=time_ms(lambda: torch.mv(KTt, x), reps),
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
                   library_ms=(None if library is None else
                               time_ms(cycling(library, copies), 200)),
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
    (bf16 levels, W) give the same bits; no hand-written kernel runs in a
    setup."""
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
                    row.update(library_ms=None, library=None,
                               composition_ms=graph_ms(lambda: torch.cat([
                                   affine_mv("ma", xd, aff, cm, ca)
                                   + affine_mv("jt", qd, aff),
                                   affine_mv("j", xd, aff)])))
                else:
                    B = dict(m=M, a=A, j=J, jt=JT,
                             ma=sps.csr_matrix(cm * M + ca * A))[mode]
                    csr = torch.sparse_csr_tensor(
                        torch.as_tensor(B.indptr, dtype=torch.int64),
                        torch.as_tensor(B.indices, dtype=torch.int64),
                        torch.as_tensor(B.data), size=B.shape).to(
                            device=dev, dtype=aff.wdet.dtype)
                    xl = xd.to(aff.wdet.dtype)[:, None]
                    row.update(library_ms=time_ms(lambda: csr @ xl, 200),
                               library="cuSPARSE CSR matvec (torch sparse "
                                       "CSR @) with the assembled matrix")
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
                library_ms=time_ms(lambda: csr @ xl, 200),
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
    rng = np.random.default_rng(20)
    out = []
    for name, shape, tin, tout, tr in (
            ("velocity 12x12", A.elem.shape, A.tab, A.tab, False),
            ("J 3x12", J.elem.shape, J.vtab, J.ptab, False),
            ("J^T", J.elem.shape, J.ptab, J.vtab, True)):
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


def wspace_kernel(prob, dt, dev):
    """The default call's w-space convection kernel (f32 tables) and bc
    values, in the order of its block-Schur solver (``_cnab_wspace``)."""
    ops = _build_ops(prob, dt, theta=0.5, linsolver="schur", layout="full",
                     device=dev)
    slv = ops.solver
    nf, nin = prob.nv_full, slv._nin
    wsrc = np.concatenate([slv.permf.cpu().numpy(), np.setdiff1d(
        np.arange(nf), np.asarray(prob.invinds))]).astype(np.int64)
    iposx = np.full(nf + 1, nf, np.int64)
    iposx[wsrc] = np.arange(nf)
    kern = prob.conv_kernel_on(torch.float32).with_dof_map(
        torch.as_tensor(iposx, device=dev))
    return kern, nin, np.asarray(prob.bc_full_vec()).ravel()[wsrc]


def quad_bound_ms(t):
    """Least time for one ``conv_quad``: ``ue``, ``ue_bc`` and the element
    tables read once, ``fe`` written once; the element chain's
    multiply-adds (``conv_bound_ms``'s, without gather or reduction) over
    the f32 rate."""
    nc, nd, Q, dim, nvpc = t.nc, t.nd, t.Q, t.dim, t.nvpc
    nbytes = 4 * (3 * nc * nd + nc * (dim * dim + Q) + Q * nvpc * (1 + dim))
    per_q = (2 * nvpc * dim + 2 * nvpc * dim * dim + 2 * dim ** 3
             + 2 * dim * dim + dim + 2 * nvpc * dim)
    flops = nc * Q * per_q + nc * nd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def abs_chain(t):
    """The tables with every factor of the quadrature chain made positive:
    ``conv_quad_ref`` on them (and on |ue|, |ue_bc|) is each row's sum of
    absolute products."""
    ta = copy.copy(t)
    ta.JinvT, ta.wdet = t.JinvT.abs(), t.wdet.abs()
    ta._plain = tuple(w.abs() for w in t.plain_weights())
    return ta


def tail_forms(tail, gen):
    """``check_band``'s forms of the tail's two int8 products, G under the
    f64 state and S under f32 element loads.  Their library forms compute
    the same 0/1 products in one PyTorch call each on inputs made
    beforehand: G as one ``index_select`` of the state (cast to f32, a zero
    appended for the bc entries), S as one cuSPARSE CSR matvec; each is
    held to the plain version first."""
    dev = tail.Sb.device
    nin, nvals = tail.nin, tail.nvals
    xg = torch.randn(nin, generator=gen, dtype=torch.float64).to(dev)
    xs = torch.randn(nvals, generator=gen, dtype=torch.float32).to(dev)
    # the 0/1 pattern: element value j reads state row rows[j] (bc rows,
    # at nin and above, read zero and are not scattered)
    rows = tail.kern.vd.reshape(-1).to(torch.int64)
    keep = rows < nin
    gidx = torch.where(keep, rows, torch.full_like(rows, nin))
    xg_pad = torch.cat([xg.float(), xg.new_zeros(1, dtype=torch.float32)])
    cols = torch.arange(nvals, device=dev)
    S_csr = torch.sparse_coo_tensor(
        torch.stack([rows[keep], cols[keep]]),
        torch.ones(int(keep.sum()), device=dev), (nin, nvals)
    ).coalesce().to_sparse_csr()
    libs = ((lambda B: torch.index_select(xg_pad, 0, gidx),
             "torch.index_select of the f32 state, a zero appended for the "
             "bc entries (made beforehand)"),
            (lambda B: S_csr @ xs,
             "cuSPARSE CSR matvec (torch sparse CSR @) of the f32 0/1 S"))
    forms = []
    for (operand, B, bases, x, nrows), lib in zip((
            ("G (gather), int8", tail.Gb, tail.Gbases, xg, nvals),
            ("S (scatter), int8", tail.Sb, tail.Sbases, xs, nin)), libs):
        ref = rect_mv_ref(B, bases, x.float(), nrows)
        err = float((lib[0](B) - ref).abs().max())
        require(err <= 1e-6 * float(ref.abs().max()),
                f"the library form of {operand} is not its product: {err}")
        forms.append((
            "rect_mv", operand, B,
            lambda B, b=bases, x=x, n=nrows: rect_mv(B, b, x, n),
            lambda B, b=bases, x=x, n=nrows: rect_mv_ref(B, b, x.float(), n),
            lambda B, b=bases, x=x, n=nrows: rect_mv_ref(
                B.abs(), b, x.float().abs(), n),
            lib,
            (1, B.shape[0], 1, B.shape[1], B.shape[2], x.shape[0], nrows,
             True, x.element_size())))
    return forms


def check_quad(tail, gen):
    """``conv_quad`` against its plain version within 1e-5 of each row's
    sum of absolute products, one kernel node a call, the same bits twice;
    timed (graph replay) beside its bound and the plain version."""
    t = tail.kern.tables
    dev = tail.ue_bc.device
    ue = torch.randn(tail.nvals, generator=gen, dtype=torch.float32).to(dev)
    y, again = conv_quad(ue, tail.ue_bc, t), conv_quad(ue, tail.ue_bc, t)
    ref = conv_quad_ref(ue, tail.ue_bc, t)
    bar = 1e-5 * conv_quad_ref(ue.abs(), tail.ue_bc.abs(), abs_chain(t)) \
        + 1e-30
    err = (y - ref).abs()
    require(bool((err <= bar).all()), "conv_quad disagrees with its plain "
            f"version: worst ratio to the row bar "
            f"{float((err / bar).max()):.3e}")
    require(torch.equal(y, again), "conv_quad is not reproducible")
    ran, types = device_kernels(lambda: conv_quad(ue, tail.ue_bc, t))
    require(ran == 1, f"conv_quad ran {ran} device kernels ({types})")
    bound, by = quad_bound_ms(t)
    ms = graph_ms(lambda: conv_quad(ue, tail.ue_bc, t))
    return dict(name="conv_quad", nc=t.nc, nvals=tail.nvals,
                max_abs_err=float(err.max()),
                max_err_over_row_bar=float((err / bar).max()),
                device_kernels_per_call=ran, ms=ms,
                eager_ms=time_ms(lambda: conv_quad(ue, tail.ue_bc, t), 200),
                plain_ms=time_ms(lambda: conv_quad_ref(ue, tail.ue_bc, t),
                                 50),
                library_ms=None, bound_ms=bound, bound_by=by,
                roofline_share=bound / ms)


def banded_conv_path(dev, gen, nsteps, ref):
    """The banded convection tail (B6) at levels 1 and 2 on the default
    call's own w-space kernel and bc tail, built with ``force``: S and G
    bytes beside the ``_window_bytes`` prediction; the int8 ``rect_mv`` on
    S and G and ``conv_quad`` against their plain versions; the tail's
    vector against B5's on the same state (1e-5 of max|B5|, bc rows zero);
    B6's three launches and B5's one timed (graph replay) beside their
    bounds; the measured stream rate and B5 cost, and the gate's decision
    under the card's constants.  Then, at level 1, the default call with
    ``banded_conv=True`` (``warm_refine`` 0 and 1) against the CPU f64 run
    ``ref`` at the default call's bars, with its exact launches.  Returns
    ``(kernel rows' checks, launches of the forced run)``."""
    levels = {}
    quad_rows, band_rows = {}, {}
    dt = (TE - T0) / NTS
    for level in (LEVEL, LEVEL2):
        prob = cylinderwake_problem(level=level, Re=RE, charvel=CHARVEL)
        kern, nin, vbc = wspace_kernel(prob, dt, dev)
        t0 = time.time()
        tail = build_banded_conv_tail(kern, nin, vbc[nin:], force=True)
        build_s = time.time() - t0
        require(tail.store == "int8" and tail.Sb.dtype == torch.int8,
                "the card's tail stores int8 blocks")
        _, rows, cols, keep = tail_patterns(kern.vd.cpu().numpy(), nin)
        bs = 256
        pred = [banded_conv._window_bytes(r, c, -(-n // bs), bs) // 4
                for r, c, n in ((rows[keep], cols[keep], nin),
                                (cols[keep], rows[keep], tail.nvals))]
        stored = [B.numel() for B in (tail.Sb, tail.Gb)]
        require(stored == pred, f"S, G bytes {stored} != predicted {pred}")
        band = check_band(tail_forms(tail, gen))
        quad = check_quad(tail, gen)
        # the tail against B5 on one w-space state: a seeded interior, the
        # real constant bc tail
        v = vbc.copy()
        v[:nin] = torch.randn(nin, generator=gen,
                              dtype=torch.float64).numpy()
        vw = torch.from_numpy(v).to(dev)
        b5 = kern.vector(vw)
        zero_counts()
        y = tail.vector(vw).clone()
        torch.cuda.synchronize()
        require(conv_quad.launches == 1 and rect_mv.launches == 2
                and rect_mv.storage_launches["int8"] == 2
                and conv_vector.launches == 0,
                "one tail vector: two int8 rect_mv and one conv_quad")
        err = float((y[:nin] - b5[:nin].float()).abs().max())
        scale = float(b5.abs().max())
        require(err <= 1e-5 * scale, f"level {level}: tail vs B5 "
                f"{err:.3e} > 1e-5 of {scale:.3e}")
        require(not bool(y[nin:].any()), "the tail's bc rows are not zero")
        ran, types = device_kernels(lambda: tail.vector(vw))
        require(ran == 3, f"one tail vector ran {ran} device kernels")
        t_tail = graph_ms(lambda: tail.vector(vw))
        t_b5 = graph_ms(lambda: kern.vector(vw))
        b5_bound, b5_by = conv_bound_ms(kern.tables, 8, False, False, 0)
        g, sc = band
        t_gs = g["ms"] + sc["ms"]
        consts = gate_constants(dev)
        by = sum(pred)
        measured = dict(
            stream_gbps=by / (t_gs * 1e-3) / 1e9,
            b5_us_per_1k_vals=1e3 * t_b5 / (tail.nvals / 1000.0))
        wins = banded_wins(by, nvals=tail.nvals, consts=consts)
        gated = build_banded_conv_tail(kern, nin, vbc[nin:])
        require((gated is not None) == (wins and by <= consts["max_gb"]
                                         * 1e9), "the gate's decision")
        levels[level] = dict(
            nin=nin, nvals=tail.nvals, nc=kern.tables.nc,
            windows=dict(wS=tail.windows[1], wG=tail.windows[4]),
            S_bytes=stored[0], G_bytes=stored[1], predicted_bytes=pred,
            build_seconds=build_s, tail_vs_b5_max_abs_err=err,
            b5_max_abs=scale, device_kernels_per_vector=ran,
            ms=dict(G=g["ms"], conv_quad=quad["ms"], S=sc["ms"],
                    tail_vector=t_tail, b5_vector=t_b5),
            bound_ms=dict(G=g["bound_ms"], conv_quad=quad["bound_ms"],
                          S=sc["bound_ms"], b5_vector=b5_bound),
            b5_bound_by=b5_by, measured=measured,
            gate=dict(constants=consts, predicted_bytes=by,
                      banded_stream_us=banded_stream_us(
                          by, consts["stream_floor_gbps"]),
                      index_pipeline_us=index_pipeline_us(
                          consts["index_us_per_1k_vals"], nvals=tail.nvals),
                      banded_wins=wins, builds=gated is not None))
        quad_rows[level], band_rows[level] = quad, band
        say(phase="banded_conv_level", level=level, int8_rect_mv=band,
            conv_quad=quad, **levels[level])
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
        c = dict(counts(), conv_quad=conv_quad.launches,
                 rect_mv_int8=rect_mv.storage_launches["int8"])
        # a loop step: the tail (G, quadrature, S), the banded A, the solve
        # (W, J, S^-1, X) and per refine round the residual (F, J^T, J) and
        # a second solve; the start: 3 Heun bootstrap vectors and the AB2
        # start value through B5
        want = dict(vecmat=0, conv_vector=4, conv_vector_amatvec=0,
                    banded_mv=nsteps * (1 + wr),
                    rect_mv=nsteps * (1 + 3 * wr) + 2 * nsteps,
                    rect_mv_levels=nsteps * 3 * (1 + wr), affine_mv=0,
                    affine_residual=0, elem_mv=0, conv_quad=nsteps,
                    rect_mv_int8=2 * nsteps)
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
    return quad_rows, band_rows, forced


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

    # -- the banded convection tail (B6), forced, against B5 and CPU f64 ----
    quad_rows, tail_rows, tail_counts = banded_conv_path(dev, gen, nsteps,
                                                         ref)

    # -- 7. the control slice at level 1, against CPU f64 ------------------
    control_modes = control_path(dev, gen, nsteps)

    # -- 8. the default call at level 2: the factors built on the card -------
    res_launches2, level2_rows = level2_path(dev, gen, nsteps)

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
            library_ms=chk["library_ms"], library=chk["library"],
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

    def tail_row(name, source, chk, launches):
        return dict(
            name=name, route="cuda", source=source, replaces=TAIL_REPLACES,
            launches=launches, operand=chk.get("operand", "conv_quad"),
            shape=chk.get("shape", dict(nc=chk.get("nc"),
                                        nvals=chk.get("nvals"))),
            max_abs_err=chk["max_abs_err"], ms=chk["ms"],
            plain_ms=chk["plain_ms"], bound_ms=chk["bound_ms"],
            bound_by=chk["bound_by"], library_ms=chk["library_ms"],
            library=chk.get("library"), eager_ms=chk["eager_ms"],
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
        # the banded convection tail: its int8 products (S at level 1) and
        # its quadrature, with the launches of the forced default call
        tail_row("rect_mv_int8", "dolfin_navier_scipy_tpu_torch/csrc/"
                 "bandmv.cu", tail_rows[LEVEL][1],
                 tail_counts["rect_mv_int8"]),
        tail_row("conv_quad", "dolfin_navier_scipy_tpu_torch/csrc/"
                 "convection.cu", quad_rows[LEVEL], tail_counts["conv_quad"])])
    say(ok=True, device=dict(platform="gpu",
                             kind=torch.cuda.get_device_name(0),
                             count=torch.cuda.device_count()))


if __name__ == "__main__":
    main()
