#!/usr/bin/env python3
"""Where a time step of the port spends its time on the card.

    python3 tools_torch/profile_step.py [--level 1] [--steps 100]
                    [--scheme cnab|sbdf2] [--layout auto|inner]
                    [--trace step_trace.json] [--root CHECKOUT]

Runs the main path and the chosen loop once to build and warm everything
(``--root``: import the package from another checkout, e.g. the parent
commit, so that two versions are profiled by the same tool), then traces
``--steps`` loop steps of ``cnab`` (same operators, dense solver, the full
state layout or with ``--layout inner`` the inner one) or of ``sbdf2``
(always the inner layout) with ``torch.profiler`` and prints, as JSON
lines: the card, the loop's wall time per step, the device-busy share (sum
of kernel time over wall time), the number of kernel launches per step,
the launches of the hand-written kernels' wrappers per step, and the
kernels by total device time.  Needs a CUDA card; ``--trace`` also writes
the chrome trace to the given file.
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



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--level", type=int, default=1)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--scheme", choices=("cnab", "sbdf2"), default="cnab")
    ap.add_argument("--layout", choices=("auto", "inner"), default="auto")
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

    prob = cylinderwake_problem(level=args.level, Re=100.0, charvel=0.2)
    dt = 1e-3
    step_loop = getattr(solve, args.scheme)
    warm = solve_nse(prob=prob, t0=0.0, tE=30 * dt, Nts=30,
                     start_ssstokes=True, linsolver="dense", save_every=0,
                     time_int_scheme=args.scheme)
    trange = np.linspace(0.0, (args.steps + 1) * dt, args.steps + 2)
    kw = dict(trange=trange, prob=prob, inivel=warm["iniv"],
              inip=warm["inip"], ops=warm["ops"], save_every=0,
              state_layout=args.layout)

    step_loop(**kw)           # this loop's own first-use costs, untimed
    # untraced, for the wall time the tracer does not inflate
    wrappers = [getattr(kernels, name) for name in
                ("vecmat", "conv_vector", "conv_vector_amatvec")
                if hasattr(kernels, name)]
    before = [w.launches for w in wrappers]
    plain = step_loop(**kw)["timing"]["loop_s"]
    # bootstrap included: three conv_vector calls (and one more for the
    # full layout's AB2 start value) beside the loop's
    wrapper_calls = {w.__name__: w.launches - b
                     for w, b in zip(wrappers, before)}
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
        layout=args.layout if args.scheme == "cnab" else "inner",
        wrapper_calls_untraced_run=wrapper_calls,
        loop_ms_per_step=1e3 * plain / args.steps,
        loop_ms_per_step_traced=1e3 * traced / args.steps,
        traced_call_seconds=t_all,
        device_busy_ms_per_step=1e-3 * busy_us / args.steps,
        device_busy_share_of_untraced_loop=1e-6 * busy_us / plain,
        note=("the traced call includes setup and the Heun bootstrap; "
              "their few kernels are in the counts"),
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
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
