#!/usr/bin/env python3
"""Where a call of the 3D affine form (``csrc/affine.cu: block_body_3d``)
spends its time, phase by phase.

    python3 tools_torch/affine_phases.py [--nz 8] [--modes m j jt res]

Needs a CUDA card.  It writes copies of this checkout's ``ops/kernels.py``
and ``csrc/affine.cu`` under ``build/phases/<variant>/`` (git-ignored),
each defining ``AFFINE3D_PHASES``, the phases of ``block_body_3d`` it
runs, and times them in turns against this checkout's kernel by
``tools_torch/affine_variants.py --wake3d NZ --quick`` (f32 tables and
vectors, one round):

* ``copies``: the bulk copies and their waits alone (no gather, no
  element terms, no facet rows, no sums);
* ``nosum``: everything but the dof sums;
* ``nocompute``: everything but the element terms;
* ``sumonly``: the copies and the sums (no gather, no element terms).

The copies' outputs are wrong by design (``same_bits_as_this`` false);
their times, and the differences between them and ``this``, are the
phases' costs.  The line after the card's name maps each ``other<k>`` of
the variants tool's rows to its variant.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PKG = os.path.join(ROOT, "dolfin_navier_scipy_tpu_torch")

# the phases each variant runs (csrc/affine.cu: AFFINE3D_PHASES; gather
# 1, facet rows 2, element terms 4, dof sums 8)
VARIANTS = {"copies": 0, "nosum": 7, "nocompute": 11, "sumonly": 10}


def write_copies(out):
    """One copy of the kernel source, built with its phases, and of its
    wrapper module a variant."""
    with open(os.path.join(PKG, "csrc", "affine.cu")) as f:
        src = f.read()
    roots = []
    for name, phases in VARIANTS.items():
        root = os.path.join(out, name)
        shutil.rmtree(root, ignore_errors=True)
        pkg = os.path.join(root, "dolfin_navier_scipy_tpu_torch")
        os.makedirs(os.path.join(pkg, "csrc"))
        os.makedirs(os.path.join(pkg, "ops"))
        with open(os.path.join(pkg, "csrc", "affine.cu"), "w") as f:
            f.write(f"#define AFFINE3D_PHASES {phases}\n" + src)
        shutil.copy(os.path.join(PKG, "ops", "kernels.py"),
                    os.path.join(pkg, "ops", "kernels.py"))
        roots.append(root)
    return roots


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nz", type=int, default=8)
    ap.add_argument("--modes", nargs="+", default=["m", "j", "jt", "res"])
    args = ap.parse_args()
    roots = write_copies(os.path.join(ROOT, "build", "phases"))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    print(json.dumps({"other" if k == 0 else f"other{k}": name
                      for k, name in enumerate(VARIANTS)}), flush=True)
    subprocess.run(
        [sys.executable, os.path.join(HERE, "affine_variants.py"),
         "--level", "--wake3d", str(args.nz), "--root", *roots,
         "--rounds", "1", "--tables", "f32", "--quick", "--modes",
         *args.modes], check=True)


if __name__ == "__main__":
    main()
