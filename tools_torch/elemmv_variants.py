#!/usr/bin/env python3
"""The element-matrix matvec (``csrc/elemmv.cu``), operand by operand, on
one card, against another checkout's kernel in turns.

    python3 tools_torch/elemmv_variants.py [--level 1 [2 [3]]]
                                           [--wake3d NZ [NZ ...]]
                                           [--root CHECKOUT [CHECKOUT ...]]
                                           [--rounds 2] [--sweep] [--quick]

Needs a CUDA card.  For each ``--level`` of the DFG 2D-1 problem
(``cylinderwake_problem(level, nu=1e-3, charvel=0.2)``) it builds the
steady matrix-free route's operand, F's f32 element blocks on the inner
velocity table (the convection's blocks at a seeded velocity from
``kern32.element_matrices`` plus the stiffness's; the table as
``SteadyKrylovKernel`` builds it, without the rest of that kernel's
state), and at level 1 also ``ElementOp`` M and A and ``DivElementOp`` J
and J^T with f32 and f64 tables (``build_element_ops``), and reads
:func:`elem_mv` on each under a seeded vector of the tables' type, one
JSON line each, after the card's name and power limit, for each version.
With ``--wake3d NZ`` (``--level`` may be left empty: ``--level``) it reads
the 3D element route's operands of the Schaefer-Turek 3D-2Z wake at nz=NZ
(``chip_smoke.py: WAKE3D``): F = M + dt/2 A in f32 (30 x 30 blocks on the
full velocity dofs, as ``solve_nse`` builds it; the staged 30-column
form) and ``DivElementOp`` J and J^T in f32 (4 x 30); at nz=2 also each
version's bits on ``chip_smoke.py: elem3d_bits_cases`` (``ELEM3D_BITS``):

* ``other`` (``other1``, ... with more ``--root``): that checkout's
  ``elem_mv`` (e.g. the parent commit, unpacked with ``git archive
  <commit> | tar -x -C build/parent``; its ``ops/kernels.py`` loaded as a
  module of its own, its ``csrc/elemmv.cu`` built into its own build
  directory);
* ``this``: this checkout's wrapper on its plan; with ``--sweep`` also
  the same wrapper on other chunks (``bps/<n>``: the plan's
  ``ELEM_BLOCKS_PER_SM`` set to ``n``; for F's 30-column blocks
  ``bps30/<n>``, ``ELEM30_BLOCKS_PER_SM``);
* the result against the plain version (``rel_err``), two launches
  against each other (``bitwise``), a CUDA-graph replay against the eager
  call (``graph_replay_equal``) and against ``this``
  (``same_bits_as_this``);
* device ms a call in a CUDA-graph replay of 20 calls (``ms``) and eager
  ms a call over back-to-back calls (``eager_ms``), read in turns (other,
  this, sweep, sweep reversed, this, other, ``--rounds`` times); the
  plain version's and one cuSPARSE CSR matvec's (``library_ms``,
  graph-replayed as the kernel; ``library_eager_ms`` back to back) time;
  the graph-replayed time of an empty kernel on this checkout's grid and
  shared memory (``floor_ms``); the bound (``chip_smoke.py:
  elem_bound_ms``); what this checkout's plan
  does (``plan``: chunk, blocks, shared memory, rows, elements touched
  and bytes of E copied, each over the operand's).

First it prints each version's bits on the seeded operands of
``chip_smoke.py: elem_bits_cases`` (``chip_smoke.py`` holds the kernel to
the earlier kernel's, ``ELEM_BITS``).
"""

import argparse
import contextlib
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, HERE]

from affine_variants import (  # noqa: E402
    events_ms, graph_ms, load_other, plan_override, replay_equal, say)
from chip_smoke import (  # noqa: E402
    DT3D, WAKE3D, dfg_problem, elem3d_bits_cases, elem_bits,
    elem_bits_cases, elem_bound_ms, elem_csr, rel)
from dolfin_navier_scipy_tpu_torch.models import (  # noqa: E402
    cylinderwake3d_problem)
from dolfin_navier_scipy_tpu_torch.ops import kernels  # noqa: E402
from dolfin_navier_scipy_tpu_torch.ops.elementop import (  # noqa: E402
    build_element_ops)
from dolfin_navier_scipy_tpu_torch.ops.kernels import DofTable  # noqa: E402

# other plans (--sweep): chunks of 2 and 8 blocks an SM; the staged
# 30-column form's own key
SWEEP = (("bps/2", dict(ELEM_BLOCKS_PER_SM=2)),
         ("bps/8", dict(ELEM_BLOCKS_PER_SM=8)))
SWEEP30 = tuple((f"bps30/{n}", dict(ELEM30_BLOCKS_PER_SM=n))
                for n in (1, 2, 4, 8, 16))


def sk_operand(prob, dev, gen):
    """F's f32 element blocks at a seeded velocity on the inner velocity
    table (``SteadyKrylovKernel.ell_dofs``, ``_sk_elem32``)."""
    nin = len(prob.invinds)
    full2in = np.full(prob.nv_full, nin, dtype=np.int64)
    full2in[prob.invinds] = np.arange(nin, dtype=np.int64)
    vd = prob.space.vdofs_of_cells().reshape(-1, 12)
    tab = DofTable(torch.as_tensor(full2in[vd], device=dev), nin)
    v = torch.randn(prob.nv_full, generator=gen, dtype=torch.float64)
    en = prob.conv_kernel_on(torch.float32, dev).element_matrices(
        v.to(dev, torch.float32), picard_only=False).reshape(-1, 12, 12)
    ea = torch.as_tensor(np.ascontiguousarray(prob.elem_tensors["A"])).to(
        dev, torch.float32)
    return en + ea, tab


def wake3d_operands(prob, dev):
    """The 3D element route's B10 operands: F = M + dt/2 A (f32, 30 x 30
    on the full velocity dofs, as ``solve/timeint.py`` builds the element
    path's F-matvec), J and J^T (f32, 4 x 30 on the inner dofs)."""
    fel = prob.elem_tensors["M"] + 0.5 * DT3D * prob.elem_tensors["A"]
    vd = prob.space.vdofs_of_cells()
    ftab = DofTable(torch.as_tensor(vd.reshape(vd.shape[0], -1),
                                    device=dev), prob.nv_full)
    F = torch.as_tensor(fel).to(dev, torch.float32)
    _, _, J = build_element_ops(prob, dtype=torch.float32, device=dev)
    return [("F = M + dt/2 A", F, ftab, ftab, False),
            ("DivElementOp J", J.elem, J.vtab, J.ptab, False),
            ("DivElementOp J^T", J.elem, J.ptab, J.vtab, True)]


def fresh(tin, tout):
    """Tables over the same ids with no plan: each chunk makes its own."""
    out = DofTable(tout.vd, tout.nseg)
    return (out if tin is tout else DofTable(tin.vd, tin.nseg)), out


def read(others, level, what, E, tin, tout, tr, args, gen):
    dev = E.device
    x = torch.randn(tin.nseg, generator=gen, dtype=torch.float64).to(
        dev, E.dtype)
    ref = kernels.elem_mv_ref(E, x, tin, tout, tr)

    def call_of(mv, tabs):
        return lambda: mv(E, x, tabs[0], tabs[1], tr)

    versions = [(tag, call_of(mod.elem_mv, fresh(tin, tout)), None)
                for tag, mod in others]
    this_tabs = fresh(tin, tout)
    versions.append(("this", call_of(kernels.elem_mv, this_tabs), {}))
    sweep_tabs = {}
    if args.sweep:
        R, C, _, sr, sc = kernels._elem_layout(E, tr)
        staged = kernels.elem_staged((R, C, sr, sc))
        for tag, keys in (SWEEP30 if staged else SWEEP):
            sweep_tabs[tag] = fresh(tin, tout)
            versions.append((tag, call_of(kernels.elem_mv, sweep_tabs[tag]),
                             keys))
    row = dict(level=level, operand=what, shape=list(E.shape),
               transpose=tr, tables=str(E.dtype), state=str(x.dtype),
               n_in=tin.nseg, n_out=tout.nseg)
    row["bound_ms"], row["bound_by"] = elem_bound_ms(E, x, tin, tout, tr)
    ys = {}
    for tag, fn, keys in versions:
        with (plan_override(kernels, **keys) if keys is not None
              else contextlib.nullcontext()):
            y, again = fn(), fn()
        torch.cuda.synchronize()
        ys[tag] = y
        row[tag] = dict(rel_err=rel(y, ref), bitwise=bool(torch.equal(
            y, again)), graph_replay_equal=replay_equal(fn, y), ms=[],
            eager_ms=[])
    for tag, _, _ in versions:
        if tag != "this":
            row[tag]["same_bits_as_this"] = bool(torch.equal(ys[tag],
                                                             ys["this"]))
    live = [(tag, fn) for tag, fn, _ in versions]
    turns = live + live[::-1]
    for _ in range(1 if args.quick else args.rounds):
        for tag, fn in turns:
            row[tag]["ms"].append(graph_ms(fn))
            if not args.quick:
                row[tag]["eager_ms"].append(events_ms(fn, args.reps))
    for tag, _ in live:
        row[tag]["share_of_bound"] = row["bound_ms"] / min(row[tag]["ms"])
    plan = kernels.elem_plan_for(E, x, *this_tabs, tr)
    row["plan"] = plan.describe()
    row["floor_ms"] = graph_ms(plan.empty)
    for tag, tabs in sweep_tabs.items():
        row[tag]["plan"] = kernels.elem_plan_for(E, x, *tabs, tr).describe()
    if not args.quick:
        row["plain_ms"] = events_ms(
            lambda: kernels.elem_mv_ref(E, x, tin, tout, tr), 20)
        csr = elem_csr(E, tin, tout, tr, x.dtype, dev)
        xl = x[:, None]
        row["library_eager_ms"] = events_ms(lambda: csr @ xl, args.reps)
        row["library_ms"] = graph_ms(lambda: csr @ xl)
    say(**row)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--level", type=int, nargs="*", default=[1, 2, 3])
    ap.add_argument("--wake3d", type=int, nargs="*", default=[])
    ap.add_argument("--root", nargs="+", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    t0 = time.time()
    log = kernels._finish_build("elemmv", *kernels._start_build(
        "elemmv", ("-Xptxas", "-v")))
    others = []
    for k, root in enumerate(args.root):
        mod = load_other(root, k)
        mod._load("elemmv")
        others.append(("other" if k == 0 else f"other{k}", mod))
    say(build_seconds=time.time() - t0, ptxas=[
        ln.strip() for ln in log.splitlines()
        if "registers" in ln or "spill" in ln or "Compiling" in ln],
        plan=kernels._AFFINE_PLAN, others=args.root,
        sm_count=torch.cuda.get_device_properties(0).multi_processor_count)
    dev = torch.device("cuda")
    cases = elem_bits_cases(dev)

    def on_fresh(mv):
        # each version its own plans: tables over the same ids
        return lambda E, x, tin, tout, tr: mv(E, x, *fresh(tin, tout), tr)

    bits = {tag: elem_bits(on_fresh(mod.elem_mv), cases)
            for tag, mod in others}
    bits["this"] = elem_bits(on_fresh(kernels.elem_mv), cases)
    say(phase="bits", bits=bits, same_as_this={
        tag: b == bits["this"] for tag, b in bits.items()})
    del cases
    gen = torch.Generator(device="cpu").manual_seed(0)
    for level in args.level:
        prob = dfg_problem(level)
        E, tab = sk_operand(prob, dev, gen)
        read(others, level, f"_sk_elem32, level {level}", E, tab, tab,
             False, args, gen)
        del E, tab
        if level == 1:
            for dt in (torch.float32, torch.float64):
                M, A, J = build_element_ops(prob, dtype=dt, device=dev)
                for name, op in (("M", M), ("A", A)):
                    read(others, level, f"ElementOp {name}, level 1",
                         op.elem, op.tab, op.tab, False, args, gen)
                read(others, level, "DivElementOp J, level 1", J.elem,
                     J.vtab, J.ptab, False, args, gen)
                read(others, level, "DivElementOp J^T, level 1", J.elem,
                     J.ptab, J.vtab, True, args, gen)
        del prob
        torch.cuda.empty_cache()
    for nz in args.wake3d:
        prob = cylinderwake3d_problem(nz=nz, **WAKE3D)
        if nz == 2:
            cases = elem3d_bits_cases(prob, dev)
            bits = {tag: elem_bits(on_fresh(mod.elem_mv), cases)
                    for tag, mod in others}
            bits["this"] = elem_bits(on_fresh(kernels.elem_mv), cases)
            say(phase="bits3d", nz=nz, bits=bits, same_as_this={
                tag: b == bits["this"] for tag, b in bits.items()})
            del cases
        for what, E, tin, tout, tr in wake3d_operands(prob, dev):
            read(others, f"3D-2Z nz={nz}", what, E, tin, tout, tr, args,
                 gen)
        del prob
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
