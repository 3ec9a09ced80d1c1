#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and no network; takes no arguments.  It

1. builds every hand-written kernel from ``dolfin_navier_scipy_tpu_torch/
   csrc/`` (one ``nvcc`` per source, started together),
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the driven paths give it (and ``vecmat`` at a ragged shape), and
   times kernel, plain version, the one-call library equivalent where there
   is one, and the card's bound,
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
   lift/drag/pressure-drop series — each against its CPU f64 twin.

Every phase prints one JSON line; any failed phase raises, so the exit
code is non-zero and the final line is missing.  The last line is
``{"ok": true, "device": {...}}``, the one before it the ``kernels`` table.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
             "False); this script only runs on the card")

from dolfin_navier_scipy_tpu_torch.models import (
    cylinderwake_problem, make_inscan_liftdrag)
from dolfin_navier_scipy_tpu_torch.ops import kernels
from dolfin_navier_scipy_tpu_torch.ops.affine import AffineVectorOps
from dolfin_navier_scipy_tpu_torch.ops.kernels import (
    conv_vector, conv_vector_amatvec, conv_vector_amatvec_ref,
    conv_vector_ref, vecmat, vecmat_ref)
from dolfin_navier_scipy_tpu_torch.solve import sbdf2, solve_nse

# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate
# and the f32 / f64 rates outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12
WRAPPERS = (vecmat, conv_vector, conv_vector_amatvec)

SEED = 0
LEVEL, RE, CHARVEL = 1, 100.0, 0.2
T0, TE, NTS, SAVE_EVERY = 0.0, 0.3, 300, 60
RAGGED = (2049, 1023)


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
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, replays) / calls


def zero_counts():
    for w in WRAPPERS:
        w.launches = 0


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


def check_vecmat(x, KT, what, reps):
    """Kernel vs plain version on the same inputs, then the timings."""
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
    KTt = KT.T                      # what the one-call library form takes
    bound, by = vecmat_bound_ms(m, n, KT.element_size())
    out = dict(shape=[m, n], operand=what, dtype=str(KT.dtype),
               max_abs_err=max_abs, max_rel_err=max_rel, atol=atol,
               rtol=rtol,
               ms=time_ms(lambda: vecmat(x, KT), reps),
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


def check_conv(kern, aff, facv, u, u2, what, sym_main, timed):
    """The convection kernel against its plain version on the same inputs:
    ``conv_vector`` with one and two states, ``conv_vector_amatvec`` with
    ``sym`` both ways and the facet blocks; two launches must give the same
    bits.  Timings (``timed``) for the one-state vector and the fused form
    the main path calls."""
    t = kern.tables
    _, rowptr, _ = t.kernel_tables()
    most = int((rowptr[1:] - rowptr[:-1]).max())
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
            row.update(ms=graph_ms(run), plain_ms=graph_ms(plain),
                       eager_ms=time_ms(run, 200),
                       plain_eager_ms=time_ms(plain, 50))
        out.append(row)
    return out


def rel(a, b):
    a, b = a.cpu().double(), b.cpu().double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


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
    # main-path shape (8-byte loads: n is even, not a multiple of 4), the
    # next multiple of 4 (16-byte loads at the same size), a ragged shape
    n4 = -(-n_main // 4) * 4
    for (m, n), what, reps in (((n_main, n_main), "random", 50),
                               ((n4, n4), "random", 50),
                               (RAGGED, "random", 200)):
        KT = torch.randn((m, n), generator=gen, dtype=torch.float32).to(dev)
        x = torch.randn(m, generator=gen, dtype=torch.float32).to(dev)
        checks.append(check_vecmat(x, KT, what, reps))
        del KT, x
    KT64 = torch.randn(RAGGED, generator=gen, dtype=torch.float64).to(dev)
    checks.append(check_vecmat(
        torch.randn(RAGGED[0], generator=gen, dtype=torch.float64).to(dev),
        KT64, "random", 200))
    del KT64
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
            u64.to(udt), v64.to(udt), "random", sym_main, timed)
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
    say(phase="kernel_checks", vecmat=checks, convection=conv_checks)

    # -- 3. the main path, through the user's entry points -----------------
    kw = dict(t0=T0, tE=TE, Nts=NTS, start_ssstokes=True,
              time_int_scheme="cnab", linsolver="dense",
              save_every=SAVE_EVERY)
    nsteps = NTS - 1          # the Heun bootstrap takes the first interval
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
                                conv_vector_amatvec=nsteps),
            f"launches on the main path: {main_counts}")
    vh = v.cpu().numpy()
    div = prob.Jc @ vh - prob.fp.ravel()
    div_scale = abs(prob.Jc) @ np.abs(vh)
    div_rel = float(np.abs(div).max() / div_scale.max())
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

    # -- 5. the rest of the DFG benchmark run, on the same problem ----------
    trange = np.linspace(T0, TE, NTS + 1)
    half = NTS // 2
    skw = dict(kw, time_int_scheme="sbdf2")
    zero_counts()
    sb = solve_nse(prob=prob, **skw)
    sb_counts = counts()
    # inner layout with f32 work: the dense apply and one refinement round
    # a step; one convection vector a step and three in the Heun bootstrap
    require(sb_counts == dict(vecmat=2 * nsteps, conv_vector=nsteps + 3,
                              conv_vector_amatvec=0),
            f"launches of the sbdf2 run: {sb_counts}")
    require(sb["ffflag"] is False and sb["v"].is_cuda, "sbdf2 run")
    # the inner layout gives the dense kernel another operand: the unpadded
    # inverse over the inner and pressure dofs, under a right-hand side of
    # that run's size (the mass matrix times its final state)
    KinvT = sb["ops"].solver.KinvT
    n_inner = nin + npc
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

    # -- the kernels table and the verdict ----------------------------------
    main_chk = checks[0]

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
            library_ms=None, eager_ms=chk["eager_ms"])

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
             library_ms=main_chk["library_ms"]),
        # the same kernel at the shape the sbdf2 run gives it
        dict(name="vecmat_inner_layout", route="cuda",
             source="dolfin_navier_scipy_tpu_torch/csrc/vecmat.cu",
             replaces="dolfin_navier_scipy_tpu/ops/pallas_kernels.py:31",
             launches=sb_counts["vecmat"], shape=sb_check["shape"],
             max_abs_err=sb_check["max_abs_err"], ms=sb_check["ms"],
             plain_ms=sb_check["plain_ms"], bound_ms=sb_check["bound_ms"],
             bound_by=sb_check["bound_by"],
             library_ms=sb_check["library_ms"]),
        conv_row("convection", f"amatvec_sym_{sym_main}",
                 main_counts["conv_vector_amatvec"]),
        conv_row("convection_vector", "vector",
                 main_counts["conv_vector"])])
    say(ok=True, device=dict(platform="gpu",
                             kind=torch.cuda.get_device_name(0),
                             count=torch.cuda.device_count()))


if __name__ == "__main__":
    main()
