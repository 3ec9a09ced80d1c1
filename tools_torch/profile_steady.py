#!/usr/bin/env python3
"""The steady solver of the port on the card, at one mesh level.

    python3 tools_torch/profile_steady.py [--level 3] [--linsolver auto]
                    [--pt-min 60000] [--newton 8] [--tol 1e-12]
                    [--skip-busy]

Solves the DFG 2D-1 steady benchmark (``cylinderwake_problem(level,
nu=1e-3, charvel=0.2)``, Re 20) through ``solve_steadystate_nse(prob,
return_vp=True, vel_pcrd_stps=2, vel_nwtn_stps=N, vel_nwtn_tol=tol,
return_nwtnupd_norms=True)`` on the card and prints, as JSON lines: the
card; the route ``auto`` took and the problem's sizes; the wall time (with
the pseudo-time march's share where the route starts with it: the
matrix-free route past ``--pt-min`` inner dofs), the Newton update norms,
each linear solve's refinement rounds, relative residual and F-matvecs,
the hand-written kernels' launches, the peak device memory; the
coefficients Cd, Cl and the pressure drop against the published values;
B10 (``elem_mv``) on the level's f32 F blocks (stiffness plus linearized
convection), by graph replay, beside its bound.  First (unless
``--skip-busy``) it prints the device-busy share of one restart cycle of
the route's f32 FGMRES (20 outer iterations, the unit a linear solve
repeats: three a refinement round) under ``torch.profiler``.

On the matrix-free route it also prints, for every linear solve, each
refinement round's f64 residual beside that residual's rounding floor
(phase ``f64_floor``): ``eps64 ||(|A + N| |v| + |J^T| |q|, |J| |v|)||``
with the host's assembled f64 matrices at the solve's linearization point
and the round's iterate ``x = (v, q)``, all over ``||b||``: a round that
stalls at that floor has met what an f64 residual can resolve.  Needs a
CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dolfin_navier_scipy_tpu_torch.models import (  # noqa: E402
    LiftDragSurfForce, cylinderwake_problem, pressure_drop)
from dolfin_navier_scipy_tpu_torch.ops import kernels  # noqa: E402
from dolfin_navier_scipy_tpu_torch.solve import steady  # noqa: E402

DFG_REF = dict(cd=5.57953523384, cl=0.010618948146, dp=0.11752016697)
HBM_BYTES_PER_S = 3.35e12
WRAPPERS = (kernels.vecmat, kernels.conv_vector, kernels.affine_mv,
            kernels.elem_mv)


def say(**kw):
    print(json.dumps(kw), flush=True)


def graph_ms(fn, calls=20, replays=10):
    """Device ms of one call of ``fn``: ``calls`` calls captured into one
    CUDA graph (on the stream that ran them first), replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / replays / calls


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--level", type=int, default=3)
    ap.add_argument("--linsolver", default="auto")
    ap.add_argument("--pt-min", type=int, default=60000)
    ap.add_argument("--newton", type=int, default=8)
    ap.add_argument("--tol", type=float, default=1e-12)
    ap.add_argument("--skip-busy", action="store_true")
    args = ap.parse_args()
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    kernels.build_all()
    prob = cylinderwake_problem(level=args.level, nu=1e-3, charvel=0.2)
    nin, npc = len(prob.invinds), prob.np_cond
    route = steady._resolve_steady_linsolver(prob, args.linsolver, dev)
    say(level=args.level, nin=nin, np_cond=npc, nc=int(prob.ctx.wdet.shape[0]),
        route=route, pseudo_time_start=(route == "krylov"
                                        and nin > args.pt_min))
    if not args.skip_busy:
        busy_cycle(prob, dev)
    for w in WRAPPERS:
        w.launches = 0
    rounds = record_rounds()
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    (v, p), norms = steady.solve_steadystate_nse(
        prob, return_vp=True, vel_pcrd_stps=2, vel_nwtn_stps=args.newton,
        vel_nwtn_tol=args.tol, return_nwtnupd_norms=True, verbose=False,
        linsolver=args.linsolver, pt_min=args.pt_min, stats=stats)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {w.__name__: w.launches for w in WRAPPERS}
    cl, cd = LiftDragSurfForce(prob).coefficients(v, p, charvel=0.2,
                                                   charlen=0.1)
    div = float(np.abs(prob.Jc @ v.ravel()[prob.invinds]
                       - prob.fp.ravel()).max())
    say(phase="solve", wall_seconds=wall,
        pseudo_time_seconds=stats.get("pseudo_time_s"), newton_norms=norms,
        solves=stats.get("solves"), f_matvecs=stats.get("n_fmv"),
        f_iters=stats.get("f_iters"), f_cycles=stats.get("f_cycles"),
        launches=launches,
        peak_device_mem_bytes=torch.cuda.max_memory_allocated(),
        coefficients=dict(cd=float(cd), cl=float(cl),
                          dp=pressure_drop(prob, p)),
        published=DFG_REF, divergence_max=div)
    if rounds:
        say(phase="f64_floor", solves=f64_floors(prob, rounds))

    sk = steady.SteadyKrylovKernel(prob, device=dev)
    vf = torch.as_tensor(v.ravel(), device=dev)
    el = steady._sk_elem32(sk, vf, False)
    x = torch.randn(sk.nin, device=dev)
    tab = sk.ell_dofs
    # E, the dof ids (one table: input and output), x and y, each once
    nbytes = el.numel() * 4 + 4 * tab.vd.numel() + 4 * 2 * sk.nin
    say(phase="elem_mv", operand=f"_sk_elem32, level {args.level}",
        shape=list(el.shape),
        ms=graph_ms(lambda: kernels.elem_mv(el, x, tab, tab)),
        bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes")


def record_rounds():
    """Wrap the matrix-free route's linear solve and f64 residual so that
    each solve keeps its linearization point and, for every residual its
    rounds take, the iterate, ``||r||`` and ``||b||`` (host copies);
    returns that list, one dict a solve."""
    solves = []
    linsolve, residual = steady._sk_linsolve, steady._sk_residual64

    def rec_linsolve(sk, v_lin_full, picard, **kw):
        solves.append(dict(v_lin=v_lin_full.cpu().numpy(), picard=picard,
                           rounds=[]))
        return linsolve(sk, v_lin_full, picard, **kw)

    def rec_residual(sk, v_lin_full, x, rhsv, rhsp, picard):
        r = residual(sk, v_lin_full, x, rhsv, rhsp, picard)
        solves[-1]["rounds"].append(
            (x.cpu().numpy(), float(torch.linalg.norm(r)),
             float(torch.linalg.norm(torch.cat([rhsv, rhsp])))))
        return r

    steady._sk_linsolve = rec_linsolve
    steady._sk_residual64 = rec_residual
    return solves


def f64_floors(prob, solves):
    """Each round's relative residual beside its f64 rounding floor (see
    the module's note), solve by solve."""
    from dolfin_navier_scipy_tpu_torch.solve.convconts import (
        get_v_conv_conts)
    import scipy.sparse as sps

    eps = np.finfo(np.float64).eps
    nin = len(prob.invinds)
    absA = abs(sps.csr_matrix(prob.Ac))
    absJ, absJT = abs(sps.csr_matrix(prob.Jc)), abs(sps.csr_matrix(prob.JTc))
    out = []
    for s in solves:
        convc, _, _ = get_v_conv_conts(vvec=s["v_lin"], prob=prob,
                                       Picard=s["picard"])
        absN = abs(sps.csr_matrix(convc))
        rows = []
        for x, rn, bn in s["rounds"]:
            v, q = np.abs(x[:nin]), np.abs(x[nin:])
            floor = eps * np.linalg.norm(np.concatenate(
                [absA @ v + absN @ v + absJT @ q, absJ @ v]))
            rows.append(dict(rel_res=rn / bn, floor_rel=floor / bn,
                             res_over_floor=rn / floor if floor else None))
        out.append(dict(picard=s["picard"], b_norm=s["rounds"][0][2]
                        if s["rounds"] else None, rounds=rows))
    return out


def busy_cycle(prob, dev):
    """The device-busy share of one FGMRES restart cycle on the Newton
    system at the boundary data (the cost of a cycle does not depend on
    the linearization point), traced before any long run in the process."""
    sk = steady.SteadyKrylovKernel(prob, device=dev)
    vf = torch.as_tensor(prob.bc_full_vec(), device=dev)
    el = steady._sk_elem32(sk, vf, False)
    r = torch.cat(steady._sk_rhs64(sk, vf, False))
    r = r / torch.linalg.norm(r)
    steady._sk_gmres(sk, el, r, restart=20, maxiter=1)
    fmv0 = sk.n_fmv
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        steady._sk_gmres(sk, el, r, restart=20, maxiter=1)
        torch.cuda.synchronize()
        cycle_wall = time.time() - t0
    dev_ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = (1e-3 * sum(e.device_time_total for e in dev_ev)
            if dev_ev else None)
    say(phase="one_fgmres_cycle", wall_seconds=cycle_wall,
        f_matvecs=sk.n_fmv - fmv0, f_iters=sk.f_iters,
        f_cycles=sk.f_cycles, device_busy_ms=busy,
        device_kernels=sum(e.count for e in dev_ev),
        busy_share=None if busy is None else 1e-3 * busy / cycle_wall,
        top=sorted(((e.key, 1e-3 * e.device_time_total, e.count)
                    for e in dev_ev), key=lambda r: -r[1])[:8])


if __name__ == "__main__":
    main()
