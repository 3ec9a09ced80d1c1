#!/usr/bin/env python3
"""Seconds of the block-Schur solver's device setup, by part, for one
checkout of the port.

    python3 tools_torch/setup_compare.py [--level 2 [3]] [--root CHECKOUT]
                                         [--repeat 2]

Builds ``SchurSaddleSolver(F, J, J^T, setup="device")`` on the DFG 2D-2
wake (``cylinderwake_problem(level, Re=100, charvel=0.2)``, ``F = M + dt/2
A``, dt 1e-3: the default call's solver) with the package imported from
``--root`` (default: this checkout), ``--repeat`` times after the kernels
are built, and prints one JSON line a build: the card, the level, the
seconds of each part (``setup_timing``: host probes, banded forms, X, S,
``S^-1``, W) and in all.  Two checkouts compare only within one call of
the card, in turns (``sh tools_torch/setup_compare.sh OTHER``)."""

import argparse
import json
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--level", type=int, nargs="+", default=[2])
    ap.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import scipy.sparse as sps
    import torch

    from dolfin_navier_scipy_tpu_torch.models import cylinderwake_problem
    from dolfin_navier_scipy_tpu_torch.ops import kernels
    from dolfin_navier_scipy_tpu_torch.solve import SchurSaddleSolver

    if not torch.cuda.is_available():
        sys.exit("setup_compare.py: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kernels.build_all()
    for level in args.level:
        prob = cylinderwake_problem(level=level, Re=100, charvel=0.2)
        F = sps.csr_matrix(prob.Mc + 0.5e-3 * prob.Ac)
        for k in range(args.repeat):
            t0 = time.time()
            slv = SchurSaddleSolver(F, prob.Jc, prob.JTc, setup="device",
                                    device="cuda")
            torch.cuda.synchronize()
            print(json.dumps(dict(
                card=card, root=os.path.abspath(args.root), level=level,
                build=k, seconds=time.time() - t0,
                parts=slv.setup_timing)), flush=True)
            del slv


if __name__ == "__main__":
    main()
