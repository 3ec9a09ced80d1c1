#!/usr/bin/env python3
"""The accuracy of the controlled inner step on the card, the port's form
beside the JAX package's.

    python3 tools_torch/control_variants.py [--level 1] [--steps 300]

Two choices of the port's inner-layout step differ from the JAX package
(``ROADMAP.md`` F11): in f32 work the continuity right-hand side of an
increment is ``g_n - J v_c`` from the carried state (the JAX package:
``g_n - g_c``), and a refined block-Schur solve applies X with all its
bf16 levels in the predictor (the JAX package: level 0 alone).  This tool
runs the two level-1 cases of ``chip_smoke.py: control_path`` that each
choice is for — (b) Robin control through ``f_tdp``, unrefined, read for
its divergence residual, and (c) static feedback ``umat = -0.5 C^T``,
``vmat = C``, one refine round, read for its distance to the CPU f64 run
— with the port as it is and with each JAX form put back for the run,
and prints one JSON line per run.  Needs a CUDA card.
"""

import argparse
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dolfin_navier_scipy_tpu_torch.control import apply_robin_penalty  # noqa: E402
from dolfin_navier_scipy_tpu_torch.models import (  # noqa: E402
    cylinderwake_problem, observation_operator)
from dolfin_navier_scipy_tpu_torch.ops.kernels import (  # noqa: E402
    rect_mv_levels)
from dolfin_navier_scipy_tpu_torch.solve import solve_nse  # noqa: E402
from dolfin_navier_scipy_tpu_torch.solve import sadpnt, timeint  # noqa: E402


def jax_continuity(prob, wdtype, device):
    """The JAX package's continuity rhs: ``g_n - g_c``."""
    return lambda g_n, c: g_n - c["gp"]


def jax_predictor(self, bvp, bpp, y0p=None, niter=None, refine=0,
                  niter_ref=None):
    """``SchurSaddleSolver._solve_core_perm`` with the JAX package's
    predictor: W's and X's level 0 alone when a refine round follows."""
    hi = refine > 0 and self.Wb is not None

    def xapply(q, hi_only=False):
        return rect_mv_levels(self.Xb, self._xbases_t, q, self._nin, hi_only)

    y = self._wapply(bvp, hi_only=hi)
    q = self._sapply(self._jmv_perm(y) - bpp)
    v = y - xapply(q, hi_only=hi)
    for _ in range(refine):
        rv = bvp - (self._fmv_perm(v) + self._jtmv_perm(q))
        rp = bpp - self._jmv_perm(v)
        s = torch.sqrt(torch.mean(rv * rv) + torch.mean(rp * rp) + 1e-30)
        y2 = self._wapply(rv / s)
        q2 = self._sapply(self._jmv_perm(y2) - rp / s)
        v = v + s * (y2 - xapply(q2))
        q = q + s * q2
    return v, q, y


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--level", type=int, default=1)
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("control_variants.py needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    kw = dict(level=args.level, Re=100.0, charvel=0.2)
    rot = cylinderwake_problem(movingwallcntrl=True, **kw)
    rob = cylinderwake_problem(bccontrol=True, **kw)
    B = apply_robin_penalty(rob, palpha=1e-3)
    C = observation_operator(rot, ny=4, odcoo=dict(
        xmin=0.3, xmax=0.5, ymin=0.1, ymax=0.3))[:, rot.invinds]

    def robin_f(device):
        fv, bd = (torch.as_tensor(a.ravel(), device=device)
                  for a in (rob.fv, B[:, 0] - B[:, 1]))
        return lambda t: fv + math.sin(10.0 * t) * bd

    dkw = dict(t0=0.0, tE=1e-3 * args.steps, Nts=args.steps,
               start_ssstokes=True, save_every=0)
    cases = dict(
        b=(rob, 0, lambda d: dict(f_tdp=robin_f(d))),
        c=(rot, 1, lambda d: dict(umat=-0.5 * C.T, vmat=C)))
    variants = dict(
        port={},
        jax_continuity=dict(obj=timeint, name="_continuity_rhs",
                            new=jax_continuity),
        jax_predictor=dict(obj=sadpnt.SchurSaddleSolver,
                           name="_solve_core_perm", new=jax_predictor))
    for case, (prob, wr, extra) in cases.items():
        ref = solve_nse(prob=prob, device="cpu", linsolver="dense",
                        **extra("cpu"), **dkw)
        for vname, patch in variants.items():
            old = getattr(patch["obj"], patch["name"]) if patch else None
            if patch:
                setattr(patch["obj"], patch["name"], patch["new"])
            try:
                o = solve_nse(prob=prob, warm_refine=wr, **extra("cuda"),
                              **dkw)
            finally:
                if patch:
                    setattr(patch["obj"], patch["name"], old)
            vh = o["v"].cpu().numpy()
            g = o["carry"]["gp"].cpu().numpy()
            div = float(np.abs(prob.Jc @ vh - g).max()
                        / (abs(prob.Jc) @ np.abs(vh)).max())
            err = float(torch.linalg.vector_norm(o["v"].cpu() - ref["v"])
                        / torch.linalg.vector_norm(ref["v"]))
            print(json.dumps(dict(level=args.level, steps=args.steps,
                                  case=case, warm_refine=wr, variant=vname,
                                  rel_err_v_vs_cpu_f64=err,
                                  divergence_residual_rel=div)), flush=True)


if __name__ == "__main__":
    main()
