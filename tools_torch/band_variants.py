#!/usr/bin/env python3
"""The banded matvecs of the block-Schur route, operand by operand, on one
card.

    python3 tools_torch/band_variants.py [--level 1 [2 3]] [--root CHECKOUT]
                                         [--rounds 2] [--sweep] [--quick]

Needs a CUDA card.  For each ``--level`` of the DFG 2D-2 wake (Re 100, dt
1e-3) it builds the default route's block-Schur solver
(``timeint._build_ops(..., linsolver="schur", layout="full")``; the device
setup at levels 2-3) and reads every banded product a step makes, on the
solver's own blocks under a seeded vector: ``banded_mv`` on the E and F
bands, ``rect_mv`` on J and J^T, ``rect_mv_levels`` on W (and W's level 0
alone), X and ``S^-1``.  One JSON line each, after the card's name and
power limit, for each version:

* ``this``: this checkout's wrapper, on the kernel its plan picks
  (``kernel``: ``"ring"``, ``"rows"`` or ``"share"``, ``ops/kernels.py:
  bandmv_plan`` and ``stack_plan``); ``ring`` (single-level f32 operands):
  the same wrapper with every such product sent to the bulk-copy ring
  kernel; ``rows``, ``share``, ``ring`` (level stacks): the same wrapper
  with the stack forced onto that form where it can take it; ``other``
  with ``--root``;
* the result against the plain version (``max_err_over_row_bar``: the
  largest error over 1e-5 of the row's sum of |B||x|; must stay <= 1), two
  launches against each other (``bitwise``) and a CUDA-graph replay
  against the eager call (``graph_replay_equal``);
* device ms a call in a CUDA-graph replay cycling over copies of the
  operand beyond three times the 50 MB L2 (``ms``: in a step each operand
  is read once among ~150 MB of others) and eager ms, read in turns
  (other, this, forms, forms reversed, this, other, ``--rounds`` times);
  the byte
  bound; one ``torch.bmm`` over pre-gathered windows (``library_ms``).

``--root CHECKOUT`` loads that checkout's ``ops/kernels.py`` (e.g. the
parent commit, unpacked with ``git archive <commit> | tar -x -C
build/parent``) as a module of its own and builds its ``csrc/bandmv.cu``
(the card, its power limit and the host's load change from call to call:
two versions compare only within one call).  ``--sweep`` also times the
ring kernel under other launch plans (``SWEEP``: blocks an SM, unit bytes,
ring bytes, fewest units a block; a plan is launch geometry, the kernel is
the same) and the share kernel of a level stack over other grids
(``SHARE_SWEEP``: blocks an SM, or rows a block).  ``--names`` reads only
the products of the wrappers named.  ``--quick`` checks every operand and
reads one graph timing a version.
"""

import argparse
import contextlib
import importlib.util
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOP_PER_S = 67e12
# launch plans of the ring kernel tried by --sweep: (blocks an SM, unit
# bytes, ring bytes, fewest units a block)
SWEEP = [dict(BLOCKS_PER_SM=b, UNIT_BYTES=u, RING_BYTES=r, MIN_UNITS=m)
         for b, u, r, m in ((1, 49152, 196608, 2), (1, 49152, 196608, 3),
                            (1, 49152, 196608, 1), (2, 24576, 98304, 2),
                            (1, 24576, 196608, 2))]
SHARE_SWEEP = [dict(SHARE_BLOCKS_PER_SM=b) for b in (1, 2, 3, 4)]
STACK_FORMS = ("rows", "share", "ring")


def say(**kw):
    print(json.dumps(kw), flush=True)


def events_ms(fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph(fn, calls):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        for _ in range(calls):
            fn()
    return g


def graph_ms(fn, calls, replays=10):
    g = graph(fn, calls)
    return events_ms(g.replay, replays) / calls


def replay_equal(fn, B, xargs, y):
    """One call captured in a CUDA graph and replayed gives ``y``'s bits."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(B, *xargs)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        got = fn(B, *xargs)
    g.replay()
    torch.cuda.synchronize()
    return bool(torch.equal(got, y))


def load_other(root):
    """``root``'s ``ops/kernels.py`` as a module of its own (it imports
    only the standard library, numpy and torch; its sources and build
    directory are its checkout's)."""
    path = os.path.join(os.path.abspath(root), "dolfin_navier_scipy_tpu_torch",
                        "ops", "kernels.py")
    spec = importlib.util.spec_from_file_location("other_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bound_ms(item, nblk, levels, bs, w, nx, nrows, bases):
    """Each stored entry, x and the window starts read once, y written
    once, over the memory rate; one multiply-add an entry over the f32
    rate (the larger bounds)."""
    entries = nblk * levels * bs * w
    nbytes = item * entries + 4 * (nx + nrows) + (4 * nblk if bases else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2.0 * entries / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def forms(slv, gen):
    """``(wrapper name, operand, blocks, args(x-side), bound args,
    levels)`` of every banded product of a step."""
    nin, npp = slv._nin, slv.np
    dev = slv.Bblk.device

    def vec(n):
        return torch.randn(n, generator=gen, dtype=torch.float32).to(dev)

    out = []
    for operand, B in (("E", slv.Eblk), ("F", slv.Bblk)):
        x = vec(nin)
        base = (torch.arange(B.shape[0], device=dev) - 1) * B.shape[1]
        out.append(("banded_mv", operand, B, (x,), base, nin, nin, None))
    for operand, B, bases, nx, nrows in (
            ("J", slv.Jb, slv._jbases_t, nin, npp),
            ("J^T", slv.JTb, slv._jtbases_t, npp, nin)):
        out.append(("rect_mv", operand, B, (bases, vec(nx), nrows), bases,
                    nx, nrows, None))
    for operand, S, bases, nx, nrows in (
            ("W", slv.Wb, slv._wbases_t, nin, nin),
            ("X", slv.Xb, slv._xbases_t, npp, nin),
            ("S^-1", slv.Sinv, slv._sbase, npp, npp)):
        x = vec(nx)
        for hi in ((False, True) if operand == "W" else (False,)):
            lev = 1 if hi else S.shape[1]
            out.append(("rect_mv_levels", operand + (" level 0" if hi else ""),
                        S, (bases, x, nrows, hi), bases, nx, nrows, lev))
    return out


def cold_copies(mod, B, nbytes=160e6):
    k = max(1, min(64, int(np.ceil(nbytes / (B.numel() * B.element_size())))))
    return [B] + [mod.as_band_operand(B) for _ in range(k - 1)]


@contextlib.contextmanager
def plan_override(kernels, **keys):
    """``kernels._BANDMV_PLAN`` with ``keys`` changed (the plans made anew
    on the way in and out)."""
    shipped = dict(kernels._BANDMV_PLAN)
    kernels._BANDMV_PLAN.update(keys)
    kernels._bandmv_plan_on.cache_clear()
    try:
        yield
    finally:
        kernels._BANDMV_PLAN.clear()
        kernels._BANDMV_PLAN.update(shipped)
        kernels._bandmv_plan_on.cache_clear()


@contextlib.contextmanager
def stack_override(kernels, **keys):
    """``kernels._STACK_PLAN`` with ``keys`` changed (the plans made anew
    on the way in and out)."""
    shipped = dict(kernels._STACK_PLAN)
    kernels._STACK_PLAN.update(keys)
    kernels._stack_plan_on.cache_clear()
    try:
        yield
    finally:
        kernels._STACK_PLAN.clear()
        kernels._STACK_PLAN.update(shipped)
        kernels._stack_plan_on.cache_clear()


def forced(kernels, tag, stack):
    """The plans under which version ``tag`` runs: the ring for every
    single-level f32 product (``ring``), one kernel form for every level
    stack (``rows``, ``share``, ``ring``), or the shipped plans."""
    if stack and tag in STACK_FORMS:
        return stack_override(kernels, FORM=tag)
    if tag == "ring":
        return plan_override(kernels, RING_GRID_BELOW=1 << 30)
    return contextlib.nullcontext()


def stack_forms(kernels, B):
    """The forms that can take level stack ``B``."""
    nblk, lev, bs, w = B.shape
    out = []
    for form in STACK_FORMS:
        try:
            kernels.stack_plan(nblk, lev, bs, w, B.stride(2),
                               B.element_size(),
                               kernels._sm_count(B.get_device()), form)
        except ValueError:
            continue
        out.append(form)
    return out


def read_form(form, versions, args, kernels):
    name, operand, B, xargs, base, nx, nrows, lev = form
    single = B.dim() == 3
    nblk, bs, w = B.shape[0], B.shape[-2], B.shape[-1]
    levels = 1 if single else lev
    bound, by = bound_ms(B.element_size(), nblk, levels, bs, w, nx, nrows,
                         name != "banded_mv")
    ref_fn = getattr(kernels, name + "_ref")
    ref = ref_fn(B, *xargs)
    absref = ref_fn(B.abs(), *[a.abs() if torch.is_tensor(a)
                               and a.is_floating_point() else a
                               for a in xargs])
    tol = 1e-5 * absref + 1e-30
    row = dict(level=args.level_now, name=name, operand=operand,
               shape=list(B.shape), dtype=str(B.dtype), bound_ms=bound,
               bound_by=by)
    copies = cold_copies(kernels, B)
    calls = max(20, len(copies))
    runs = {}
    stack = name == "rect_mv_levels"
    ring_tag = single and B.dtype == torch.float32
    extra = (stack_forms(kernels, B[:, :levels]) if stack
             else ["ring"] if ring_tag else [])
    tags = [(t, m) for t, m in versions] + [(t, kernels) for t in extra]
    for tag, mod in tags:
        with forced(kernels, tag, stack):
            fn = getattr(mod, name)
            y, again = fn(B, *xargs), fn(B, *xargs)
            torch.cuda.synchronize()
            err = (y - ref).abs()
            row[tag] = dict(max_err_over_row_bar=float((err / tol).max()),
                            bitwise=bool(torch.equal(y, again)),
                            graph_replay_equal=replay_equal(fn, B, xargs, y),
                            ms=[], eager_ms=[])
            if mod is kernels:
                row[tag]["kernel"] = kernel_of(kernels, name, B, levels)
        it = itertools.cycle(copies)
        runs[tag] = lambda fn=fn, it=it: fn(next(it), *xargs)
    # one torch.bmm over the windows gathered beforehand (x cast to the
    # blocks' type; the levels' row sum is not in it)
    C = B[:, None] if single else B[:, :lev]
    nl = C.shape[1]
    xw = kernels._windows(xargs[0] if name == "banded_mv" else xargs[1],
                          base, w).to(B.dtype)[:, :, None].contiguous()
    itl = itertools.cycle(copies)

    def lib():
        D = next(itl)
        D = D[:, None] if single else D[:, :lev]
        return torch.bmm(D.reshape(nblk, nl * bs, w), xw)

    order = [t for t, _ in tags]
    turns = order + order[::-1]
    for _ in range(1 if args.quick else args.rounds):
        for tag in turns:
            with forced(kernels, tag, stack):
                row[tag]["ms"].append(graph_ms(runs[tag], calls))
                if not args.quick:
                    row[tag]["eager_ms"].append(
                        events_ms(runs[tag], args.reps))
    row["library_ms"] = None if args.quick else graph_ms(lib, calls)
    row["timed_over_copies"] = len(copies)
    for tag in order:
        row[tag]["share_of_bound"] = bound / min(row[tag]["ms"])
    if args.sweep and ring_tag:
        row["sweep"] = sweep(kernels, runs["ring"], B, calls)
    if args.sweep and "share" in extra:
        row["sweep"] = share_sweep(kernels, runs["share"], B[:, :levels],
                                   calls)
    say(**row)
    return row


def kernel_of(kernels, name, B, levels):
    """The kernel form a call of wrapper ``name`` on ``B`` launches."""
    nblk, bs, w = B.shape[0], B.shape[-2], B.shape[-1]
    dev = B.get_device()
    if name == "rect_mv_levels":
        return kernels._stack_plan_on(nblk, levels, bs, w, B.stride(-2),
                                      B.element_size(), dev,
                                      kernels._STACK_PLAN["FORM"]).kernel
    if B.dtype != torch.float32:
        return "rows"
    return kernels._bandmv_plan_on(nblk, bs, w, B.stride(-2), dev).kernel


def share_sweep(kernels, run, B, calls):
    """The share kernel of a level stack over other grids."""
    out = []
    for variant in SHARE_SWEEP:
        with stack_override(kernels, FORM="share", **variant):
            out.append(dict(plan=variant, ms=graph_ms(run, calls)))
    return out


def sweep(kernels, run, B, calls):
    """The ring kernel under other launch plans."""
    out = []
    nblk, bs, w = B.shape
    for variant in SWEEP:
        with plan_override(kernels, RING_GRID_BELOW=1 << 30, **variant):
            plan = kernels._bandmv_plan_on(nblk, bs, w, B.stride(1),
                                           B.get_device())
            out.append(dict(plan=variant, launch=plan._asdict(),
                            ms=graph_ms(run, calls)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--level", type=int, nargs="+", default=[1])
    ap.add_argument("--root", default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--names", nargs="+", default=None,
                    help="read only these wrappers' products")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("band_variants.py needs a CUDA card")
    from dolfin_navier_scipy_tpu_torch.models import cylinderwake_problem
    from dolfin_navier_scipy_tpu_torch.ops import kernels
    from dolfin_navier_scipy_tpu_torch.solve.timeint import _build_ops
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    t0 = time.time()
    versions = [("this", kernels)]
    logs = kernels.build_all(extra_flags=("-Xptxas", "-v"))
    if args.root:
        other = load_other(args.root)
        other.build_all()
        versions.insert(0, ("other", other))
    say(build_seconds=time.time() - t0, ptxas=[
        ln.strip() for ln in logs["bandmv"].splitlines()
        if "registers" in ln or "spill" in ln or "Compiling" in ln],
        plan=kernels._BANDMV_PLAN, stack_plan=kernels._STACK_PLAN,
        geometry=kernels._BANDMV_GEOMETRY, other=args.root)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    for level in args.level:
        args.level_now = level
        t0 = time.time()
        prob = cylinderwake_problem(level=level, Re=100.0, charvel=0.2)
        ops = _build_ops(prob, 1e-3, theta=0.5, linsolver="schur",
                         layout="full", device=dev)
        torch.cuda.synchronize()
        slv = ops.solver
        say(level=level, setup_seconds=time.time() - t0, setup=slv.setup,
            nin=slv._nin, np=slv.np, bs=slv._bs, nblk=slv._nblk)
        for form in forms(slv, gen):
            if args.names is None or form[0] in args.names:
                read_form(form, versions, args, kernels)
        del ops, slv, prob
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
