#!/usr/bin/env python3
"""Where a time step of the port spends its time on the card.

    python3 tools_torch/profile_step.py [--level 1] [--steps 100]
                    [--scheme cnab|sbdf2] [--layout auto|inner]
                    [--linsolver dense|schur|auto] [--setup auto|host|device]
                    [--warm-refine 0 [1 ...]] [--check-x 4]
                    [--control none|rotcyl|static|dynamic]
                    [--trace step_trace.json] [--root CHECKOUT]

Runs the main path and the chosen loop once to build and warm everything
(``--root``: import the package from another checkout, e.g. the parent
commit, so that two versions are profiled by the same tool), then traces
``--steps`` loop steps of ``cnab`` (same operators; the dense solver or with
``--linsolver schur`` the banded block-Schur one, whose full layout is the
permuted w-space step with ``--warm-refine`` residual rounds — each value
given is profiled in turn on the same operators; ``--linsolver auto`` is
the user's default call; the full state layout or with ``--layout inner``
the inner one) or of ``sbdf2`` (always the inner layout) with
``torch.profiler`` and prints, as JSON lines: the card; the setup (the
Schur solver's parts in seconds — host probes, banded forms, X, S,
``S^-1``, W — the operators' and the Heun bootstrap's seconds, the peak
device memory of the warm run); for each loop, its wall time per step, the
device-busy share (sum of kernel time over wall time), the number of
kernel launches per step, the launches of the hand-written kernels'
wrappers per step, the final state's divergence residual and the kernels
by total device time.  ``--setup`` forces the Schur solver's setup (the
integrators build it through ``timeint._build_ops``, which takes no such
keyword, so the tool fixes it on the class they call); ``--check-x N``
holds N columns of the stored X against exact host-CG solves.
``--control`` drives the controlled inner-layout step: ``rotcyl`` the
rotating cylinder (a Dirichlet control ``sin(20 t)``), ``static`` static
feedback ``umat = -0.5 C^T``, ``vmat = C`` (C averages the velocity over 4
strips of a box behind the cylinder), ``dynamic`` a seeded LTI observer
(AB2) through ``dynamic_rhs``; controls and feedback take the inner layout
(``--layout`` is then ``inner``); the observer's input and the actuation
are ``C`` and ``1e-2 C^T``.  Needs a CUDA card; ``--trace`` also
writes the chrome trace of the last loop.
"""

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spsla
import torch
from torch.profiler import ProfilerActivity, profile


def check_x(slv, prob, dt, ncols):
    """Stored X (levels summed) against ``F^{-1} J^T`` columns solved by
    host CG to 1e-10, at ``ncols`` pressure columns spread over the ``pp``
    order: the largest error relative to the column's largest entry."""
    F = sps.csr_matrix(prob.Mc + 0.5 * dt * prob.Ac)
    Mdiag = sps.diags(1.0 / F.diagonal())
    jT = sps.csc_matrix(prob.JTc)
    perm = slv.permf.cpu().numpy()
    if slv.nv != slv._nin:              # full_map: RCM over the inner rows
        pos = np.full(slv.nv, -1)
        pos[np.asarray(prob.invinds)] = np.arange(len(prob.invinds))
        perm = pos[perm]
    pp = slv.pidx.cpu().numpy()
    xs = slv.Xb.float()
    if xs.dim() == 4:
        xs = xs.sum(1)
    bs, wx, nin = slv._bs, slv._wx, slv._nin
    out = []
    for c in np.unique(np.linspace(0, slv.np - 1, ncols).astype(int)):
        col = np.asarray(jT[:, int(pp[c])].todense()).ravel()
        x, _ = spsla.cg(F, col, rtol=1e-10, atol=0.0, maxiter=2000, M=Mdiag)
        stored = np.zeros(nin)
        for kb, b in enumerate(slv._xbases):
            if b <= c < b + wx:
                rows = min(bs, nin - kb * bs)
                stored[kb * bs: kb * bs + rows] = \
                    xs[kb, :rows, c - b].cpu().numpy()
        exact = x[perm]
        out.append(dict(column=int(c), max_err_over_col_max=float(
            np.abs(stored - exact).max() / np.abs(exact).max())))
    return out


def control_kwargs(control, prob):
    """The integrator keywords of ``--control`` on ``prob`` (a wake built
    with ``movingwallcntrl`` unless ``control`` is 'none')."""
    if control == "none":
        return {}
    import math

    from dolfin_navier_scipy_tpu_torch.control import get_heunab_lti
    from dolfin_navier_scipy_tpu_torch.models import observation_operator
    from dolfin_navier_scipy_tpu_torch.solve import DirichletControl

    if control == "rotcyl":
        dofs, stencil = prob.dircntrl[0]
        return dict(controls=[DirichletControl(
            dofs, stencil,
            lambda t, v, p, mem, mode: (math.sin(20.0 * t), mem))])
    C = observation_operator(prob, ny=4, odcoo=dict(
        xmin=0.3, xmax=0.5, ymin=0.1, ymax=0.3))[:, prob.invinds]
    if control == "static":
        return dict(umat=-0.5 * C.T, vmat=C)
    ny, hN = C.shape[0], 4
    rng = np.random.default_rng(0)
    fbk, mem0 = get_heunab_lti(
        ha=-np.eye(hN) + 0.05 * rng.normal(size=(hN, hN)),
        hb=0.3 * rng.normal(size=(hN, ny)),
        hc=0.05 * rng.normal(size=(ny, hN)), inihx=np.ones(hN))
    B = torch.as_tensor(1e-2 * C.T, device="cuda")
    Ct = torch.as_tensor(C, device="cuda")

    def dynamic_rhs(t, vc=None, memory=None, mode=None):
        u, memory = fbk(t, vc=Ct @ vc, memory=memory, mode=mode)
        return B @ u, memory

    return dict(dynamic_rhs=dynamic_rhs, dynamic_rhs_memory=mem0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--level", type=int, default=1)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--scheme", choices=("cnab", "sbdf2"), default="cnab")
    ap.add_argument("--layout", choices=("auto", "inner"), default="auto")
    ap.add_argument("--linsolver", choices=("dense", "schur", "auto"),
                    default="dense")
    ap.add_argument("--setup", choices=("auto", "host", "device"),
                    default="auto")
    ap.add_argument("--warm-refine", type=int, nargs="+", default=[0])
    ap.add_argument("--check-x", type=int, default=0)
    ap.add_argument("--control", choices=("none", "rotcyl", "static",
                                          "dynamic"), default="none")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_step.py needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.root))
    from dolfin_navier_scipy_tpu_torch import solve
    from dolfin_navier_scipy_tpu_torch.models import cylinderwake_problem
    from dolfin_navier_scipy_tpu_torch.ops import kernels
    from dolfin_navier_scipy_tpu_torch.solve import solve_nse
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    if args.setup != "auto":
        solve.timeint.SchurSaddleSolver = functools.partial(
            solve.timeint.SchurSaddleSolver, setup=args.setup)

    t0 = time.perf_counter()
    prob = cylinderwake_problem(level=args.level, Re=100.0, charvel=0.2,
                                movingwallcntrl=args.control != "none")
    problem_s = time.perf_counter() - t0
    dt = 1e-3
    extra = control_kwargs(args.control, prob)
    if extra:
        args.layout = "inner"
    step_loop = getattr(solve, args.scheme)
    torch.cuda.reset_peak_memory_stats()
    # the warm run builds the plain operators (a feedback run wraps them
    # in an SMW solver anew at every call)
    warm = solve_nse(prob=prob, t0=0.0, tE=30 * dt, Nts=30,
                     start_ssstokes=True, linsolver=args.linsolver,
                     save_every=0, time_int_scheme=args.scheme,
                     state_layout=args.layout,
                     **{k: v for k, v in extra.items()
                        if k not in ("umat", "vmat")})
    peak = torch.cuda.max_memory_allocated()
    slv = warm["ops"].solver
    setup = dict(
        level=args.level, nin=len(prob.invinds), np=prob.np_cond,
        solver=type(slv).__name__, problem_seconds=problem_s,
        timing_first_call=warm["timing"],
        peak_device_mem_bytes_first_call=peak)
    if hasattr(slv, "setup_timing"):
        setup.update(setup=slv.setup, parts_seconds=slv.setup_timing,
                     ncg=slv.ncg, bs=slv._bs, nblk=slv._nblk, ww=slv._ww,
                     wx=slv._wx, Xb=list(slv.Xb.shape),
                     Wb=None if slv.Wb is None else list(slv.Wb.shape),
                     Sinv=list(slv.Sinv.shape))
        if args.check_x:
            setup["x_vs_host_cg"] = check_x(slv, prob, dt, args.check_x)
    trange = np.linspace(0.0, (args.steps + 1) * dt, args.steps + 2)
    kw = dict(trange=trange, prob=prob, inivel=warm["iniv"],
              inip=warm["inip"], ops=warm["ops"], save_every=0,
              state_layout=args.layout, **extra)
    wrappers = [getattr(kernels, name) for name in
                ("vecmat", "conv_vector", "conv_vector_amatvec", "banded_mv",
                 "rect_mv", "rect_mv_levels", "affine_mv", "affine_residual")
                if hasattr(kernels, name)]
    for wr in (args.warm_refine if args.scheme == "cnab" else [None]):
        if wr is not None:
            kw["warm_refine"] = wr
        step_loop(**kw)       # this loop's own first-use costs, untimed
        # untraced, for the wall time the tracer does not inflate
        before = [w.launches for w in wrappers]
        plain_out = step_loop(**kw)
        plain = plain_out["timing"]["loop_s"]
        # bootstrap included: three conv_vector calls (and one more for the
        # full layout's AB2 start value) beside the loop's
        wrapper_calls = {w.__name__: w.launches - b
                         for w, b in zip(wrappers, before)}
        vh = plain_out["v"].cpu().numpy()
        # the continuity rhs of the last step (fp, and -J_bc cvals with a
        # Dirichlet control)
        g = (plain_out["carry"]["gp"].cpu().numpy()
             if "gp" in plain_out["carry"] and args.layout == "inner"
             else prob.fp.ravel())
        div_rel = float(np.abs(prob.Jc @ vh - g).max()
                        / (abs(prob.Jc) @ np.abs(vh)).max())
        del plain_out
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            traced = step_loop(**kw)["timing"]["loop_s"]
            torch.cuda.synchronize()
            t_all = time.perf_counter() - t0
        evs = prof.key_averages()
        dev_us = {e.key: (e.device_time_total, e.count) for e in evs
                  if e.device_type == torch.autograd.DeviceType.CUDA}
        busy_us = sum(v[0] for v in dev_us.values())
        nlaunch = sum(v[1] for v in dev_us.values())
        print(json.dumps(dict(
            level=args.level, steps=args.steps, scheme=args.scheme,
            control=args.control,
            layout=args.layout if args.scheme == "cnab" else "inner",
            linsolver=args.linsolver, solver=type(slv).__name__,
            warm_refine=wr,
            wrapper_calls_untraced_run=wrapper_calls,
            loop_ms_per_step=1e3 * plain / args.steps,
            loop_ms_per_step_traced=1e3 * traced / args.steps,
            traced_call_seconds=t_all,
            device_busy_ms_per_step=1e-3 * busy_us / args.steps,
            device_busy_share_of_untraced_loop=1e-6 * busy_us / plain,
            divergence_residual_rel=div_rel,
            note=("the traced call includes the Heun bootstrap; its few "
                  "kernels are in the counts"),
            device_kernels_per_step=nlaunch / args.steps)), flush=True)
        top = sorted(dev_us.items(), key=lambda kv: -kv[1][0])[:25]
        for name, (us, cnt) in top:
            print(json.dumps(dict(kernel=name[:90], device_us_total=us,
                                  count=cnt, us_each=us / max(cnt, 1))),
                  flush=True)
        cpu_top = sorted((e for e in evs if e.device_type
                          == torch.autograd.DeviceType.CPU),
                         key=lambda e: -e.self_cpu_time_total)[:15]
        for e in cpu_top:
            print(json.dumps(dict(host_op=e.key[:60],
                                  self_cpu_us_total=e.self_cpu_time_total,
                                  count=e.count)), flush=True)
    setup["peak_device_mem_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps(setup), flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
