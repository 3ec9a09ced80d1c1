#!/usr/bin/env python3
"""The affine element matvecs (``csrc/affine.cu``), mode by mode, on one
card, against another checkout's kernel in turns.

    python3 tools_torch/affine_variants.py [--level 1 [2]]
                                           [--wake3d NZ [NZ ...]]
                                           [--root CHECKOUT [CHECKOUT ...]]
                                           [--rounds 2] [--sweep] [--quick]

Needs a CUDA card.  For each ``--level`` of the DFG 2D-2 wake (Re 100) it
builds the inner-layout tables the dense solver's route uses
(``prob.affine_ops``, f32 and f64 tables) and reads every mode of
:func:`affine_mv` ('m', 'a' with its facet rows, 'ma' with ``ca`` 5e-4,
'j', 'jt') on the vector type the paths give it (f64 under 'a', the f64
carry; f32 elsewhere) and the fused residual :func:`affine_residual`
(modes 'res'), one JSON line each, after the card's name and power limit,
for each version.  With ``--wake3d NZ`` (``--level`` may be left empty:
``--level``) it reads the 3D form on the full-dof tables of the
Schaefer-Turek 3D-2Z wake at nz=NZ (``chip_smoke.py: WAKE3D``; f32 and f64
tables, f32 vectors, as ``chip_smoke.py`` times them; the bound
``chip_smoke.py: affine3d_bound_ms``, the library's residual one cuSPARSE
CSR matvec of the assembled saddle operator); at nz=2 first each
version's bits on ``chip_smoke.py: affine3d_bits_cases``
(``AFFINE3D_BITS``):

* ``other`` (``other1``, ... with more ``--root``): that checkout's
  ``affine_mv`` and its ``affine_residual`` or, where it has none, for
  'res' the composition that checkout's dense solver made (three
  ``affine_mv`` launches, an add and a concatenation; ``"as":
  "composition"`` in its entry) (e.g. the parent commit, unpacked with
  ``git archive <commit> | tar -x -C build/parent``; its
  ``ops/kernels.py`` loaded as a module of its own, its ``csrc/affine.cu``
  built into its own build directory);
* ``this``: this checkout's wrapper on the chunk :func:`affine_plan`
  picks; with ``--sweep`` also ``bps/<n>``, the same wrapper with the
  plan's ``BLOCKS_PER_SM`` set to ``n`` (other chunks; the row's
  ``chunks`` says which);
* the result against the plain version (``max_err_over_row_bar``: the
  largest error over 1e-5 of the row's sum of absolute products; must
  stay <= 1), two launches against each other (``bitwise``), a CUDA-graph
  replay against the eager call (``graph_replay_equal``) and against
  ``this`` (``same_bits_as_this``);
* device ms a call in a CUDA-graph replay of 20 calls (``ms``) and eager
  ms a call over back-to-back calls (``eager_ms``: the host's cost where
  it is the larger), read in turns (other, this, sweep, sweep reversed,
  this, other, ``--rounds`` times); the graph-replayed time of an empty
  kernel on the same grid (``floor_ms``); the plain version's and one
  cuSPARSE CSR matvec's (``library_ms``, graph-replayed as the kernel;
  ``library_eager_ms`` back to back) time; the bound.  For 'res'
  also the composition it replaces on this checkout's kernel (three
  launches, an add and a concatenation; ``composition_ms`` and whether
  the fused bits equal it).
"""

import argparse
import contextlib
import copy
import importlib.util
import json
import os
import subprocess
import sys
import time

import scipy.sparse as sps
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12
MODES = (("m", 1.0, 0.0), ("a", 0.0, 1.0), ("ma", 1.0, 5e-4),
         ("j", 1.0, 0.0), ("jt", 1.0, 0.0), ("res", 1.0, 5e-4))
STATE = dict(m=torch.float32, a=torch.float64, ma=torch.float32,
             j=torch.float32, jt=torch.float32, res=torch.float32)
STATE3D = dict.fromkeys(STATE, torch.float32)
SWEEP_BLOCKS_PER_SM = (1, 3, 4, 6, 8)


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
        out = [fn() for _ in range(calls)]
    return g, out


def graph_ms(fn, calls=20, replays=10):
    g, _ = graph(fn, calls)
    return events_ms(g.replay, replays) / calls


def replay_equal(fn, y):
    g, out = graph(fn, 1)
    g.replay()
    torch.cuda.synchronize()
    return bool(torch.equal(out[0], y))


def load_other(root, k=0):
    """``root``'s ``ops/kernels.py`` as a module of its own (it imports
    only the standard library, numpy, scipy and torch)."""
    path = os.path.join(os.path.abspath(root), "dolfin_navier_scipy_tpu_torch",
                        "ops", "kernels.py")
    spec = importlib.util.spec_from_file_location(f"other_kernels{k}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def abs_tables(aff):
    t = copy.copy(aff)
    for k in ("W2", "W2T", "MrefI2", "N1q", "JinvT", "wdet", "detJ",
              "fac_elem"):
        setattr(t, k, getattr(aff, k).abs())
    return t


def fresh(aff):
    """A shallow copy of the tables with no launch plan: each version and
    chunk makes its own."""
    t = copy.copy(aff)
    t._plans = {}
    return t


@contextlib.contextmanager
def plan_override(kernels, **keys):
    shipped = dict(kernels._AFFINE_PLAN)
    kernels._AFFINE_PLAN.update(keys)
    try:
        yield
    finally:
        kernels._AFFINE_PLAN.update(shipped)


def bound_ms(t, mode, x_item):
    """Inputs read once and the output written once over the memory rate;
    the per-point multiply-adds over the work type's rate (the larger
    bounds; as ``chip_smoke.py: affine_bound_ms``)."""
    s = t.wdet.element_size()
    nc, Q, dim, nvpc, pn = t.nc, t.Q, t.dim, t.nvpc, t.pnpc
    nd = nvpc * dim
    nfac = int(t.fac_elem.shape[0]) if mode in ("a", "ma", "res") else 0
    n_in = dict(jt=t.npc, res=t.nin + t.npc).get(mode, t.nin)
    n_out = dict(j=t.npc, res=t.nin + t.npc).get(mode, t.nin)
    ids = dict(jt=pn, res=nd + pn).get(mode, nd)
    nbytes = (x_item * (n_in + n_out) + 4 * nc * ids
              + s * nc * (dim * dim + Q + (mode in ("m", "ma", "res")))
              + s * Q * (nvpc * (1 + dim) + pn + 1)
              + nfac * nd * (s * nd + 4))
    grad = 2 * nvpc * dim * dim + 2 * dim ** 3
    per_q = dict(m=4 * nvpc * dim + dim + 2,
                 a=grad + 4 * dim ** 3 + 2 * nvpc * dim * dim,
                 j=grad + dim + 2 * pn,
                 jt=2 * pn + 2 * nvpc * dim * dim + 2 * nvpc * dim)
    per_q["ma"] = per_q["a"] + per_q["m"]
    per_q["res"] = per_q["ma"] + per_q["jt"] + dim + 2 * pn
    out_terms = dict(j=pn, res=2 * nd + pn).get(mode, nd)
    flops = nc * Q * per_q[mode] + 2 * nfac * nd * nd + nc * out_terms
    rate = F32_FLOP_PER_S if s == 4 else F64_FLOP_PER_S
    tb, to = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"


def read_mode(kernels, others, prob, aff, mode, cm, ca, args, gen):
    dev = aff.wdet.device
    d3 = aff.dim == 3
    xdt = (STATE3D if d3 else STATE)[mode]
    n = aff.npc if mode == "jt" else aff.nin
    x = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, xdt)
    q = torch.randn(aff.npc, generator=gen,
                    dtype=torch.float64).to(dev, xdt)
    absaff = abs_tables(aff)
    if mode == "res":
        ref = kernels.affine_residual_ref(x, q, aff, cm, ca)
        bar = 1e-5 * kernels.affine_residual_ref(
            x.double().abs(), q.double().abs(), absaff, cm, ca) + 1e-30
    else:
        ref = kernels.affine_mv_ref(mode, x, aff, cm, ca)
        bar = 1e-5 * kernels.affine_mv_ref(mode, x.double().abs(), absaff,
                                           cm, ca) + 1e-30

    def call_of(mod, t):
        if mode == "res" and not hasattr(mod, "affine_residual"):
            def comp():
                return torch.cat([mod.affine_mv("ma", x, t, cm, ca)
                                  + mod.affine_mv("jt", q, t),
                                  mod.affine_mv("j", x, t)])
            return comp
        if mode == "res":
            return lambda: mod.affine_residual(x, q, t, cm, ca)
        return lambda: mod.affine_mv(mode, x, t, cm, ca)

    versions = [(tag, call_of(mod, fresh(aff)), None) for tag, mod in others]
    versions.append(("this", call_of(kernels, fresh(aff)), {}))
    if args.sweep:
        versions += [(f"bps/{n}", call_of(kernels, fresh(aff)),
                      dict(BLOCKS_PER_SM=n)) for n in SWEEP_BLOCKS_PER_SM]
    row = dict(level=args.level_now, mode=mode, tables=str(aff.wdet.dtype),
               state=str(xdt), nc=aff.nc, nin=aff.nin, npc=aff.npc,
               facet_blocks=int(aff.fac_elem.shape[0]), cm=cm, ca=ca)
    if d3:
        row["bound_ms"], row["bound_by"] = args.bound3d(
            aff, mode, x.element_size(),
            mode in ("a", "ma", "res") and ca != 0.0)
    else:
        row["bound_ms"], row["bound_by"] = bound_ms(aff, mode,
                                                    x.element_size())
    for tag, fn, keys in versions:
        with (plan_override(kernels, **keys) if keys is not None
              else contextlib.nullcontext()):
            y, again = fn(), fn()
        torch.cuda.synchronize()
        err = (y.double() - ref.double()).abs()
        got = dict(max_err_over_row_bar=float((err / bar).max()),
                   bitwise=bool(torch.equal(y, again)),
                   graph_replay_equal=replay_equal(fn, y), ms=[],
                   eager_ms=[])
        got["y"] = y
        if mode == "res" and tag.startswith("other") and not hasattr(
                dict(others)[tag], "affine_residual"):
            got["as"] = "composition"
        row[tag] = got
    this_y = row["this"].pop("y")
    for tag, _, _ in versions:
        if tag != "this" and "y" in row[tag]:
            row[tag]["same_bits_as_this"] = bool(torch.equal(
                row[tag].pop("y"), this_y))
    live = [(tag, fn) for tag, fn, _ in versions]
    turns = live + live[::-1]
    for _ in range(1 if args.quick else args.rounds):
        for tag, fn in turns:
            row[tag]["ms"].append(graph_ms(fn))
            if not args.quick:
                row[tag]["eager_ms"].append(events_ms(fn, args.reps))
    for tag, _ in live:
        row[tag]["share_of_bound"] = row["bound_ms"] / min(row[tag]["ms"])
    # the floor: an empty kernel on the grid of this checkout's launch
    t_this = fresh(aff)
    (call_of(kernels, t_this))()
    row["floor_ms"] = graph_ms(lambda: kernels._affine_launch(
        mode, x, q if mode == "res" else None, t_this, cm, ca, empty=True))
    plan = next(iter(t_this._plans.values()))
    row["chunk"] = plan.call(mode, cm, ca, xdt).chunk
    if args.sweep:
        row["chunks"] = {}
        for n in SWEEP_BLOCKS_PER_SM:
            with plan_override(kernels, BLOCKS_PER_SM=n):
                t_n = fresh(aff)
                (call_of(kernels, t_n))()
                row["chunks"][f"bps/{n}"] = next(iter(
                    t_n._plans.values())).call(mode, cm, ca, xdt).chunk
    if args.quick:
        say(**row)
        return row
    if d3:
        f = prob.full
        M, A, J, JT = f["M"], f["A"], f["J"], f["JT"]
    else:
        M, A, J, JT = prob.Mc, prob.Ac, prob.Jc, prob.JTc
    saddle = None
    if mode == "res":
        Kop, Jop = aff.view("ma", cm=cm, ca=ca), aff.view("j")

        def comp():
            return torch.cat([Kop.matvec(x) + Jop.rmatvec(q),
                              Jop.matvec(x)])

        yc = comp()
        row["composition_ms"] = graph_ms(comp)
        row["composition_eager_ms"] = events_ms(comp, args.reps)
        row["fused_equals_composition_bits"] = bool(torch.equal(this_y, yc))
        row["fused_vs_composition_max_abs"] = float(
            (this_y.double() - yc.double()).abs().max())
        row["plain_ms"] = events_ms(
            lambda: kernels.affine_residual_ref(x, q, aff, cm, ca), 20)
        # the library's one call: the assembled saddle operator on [x; q]
        saddle = sps.bmat([[cm * M + ca * A, JT], [J, None]])
    else:
        row["plain_ms"] = events_ms(
            lambda: kernels.affine_mv_ref(mode, x, aff, cm, ca), 20)
    B = sps.csr_matrix(saddle if saddle is not None else dict(
        m=M, a=A, j=J, jt=JT, ma=cm * M + ca * A)[mode])
    csr = torch.sparse_csr_tensor(
        torch.as_tensor(B.indptr, dtype=torch.int64),
        torch.as_tensor(B.indices, dtype=torch.int64),
        torch.as_tensor(B.data), size=B.shape).to(dev, aff.wdet.dtype)
    xl = (torch.cat([x, q]) if mode == "res" else x).to(
        aff.wdet.dtype)[:, None]
    row["library_eager_ms"] = events_ms(lambda: csr @ xl, args.reps)
    row["library_ms"] = graph_ms(lambda: csr @ xl)
    say(**row)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--level", type=int, nargs="*", default=[1])
    ap.add_argument("--wake3d", type=int, nargs="*", default=[])
    ap.add_argument("--root", nargs="+", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--modes", nargs="+", default=None)
    ap.add_argument("--tables", nargs="+", default=["f32", "f64"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("affine_variants.py needs a CUDA card")
    from dolfin_navier_scipy_tpu_torch.models import cylinderwake_problem
    from dolfin_navier_scipy_tpu_torch.ops import kernels
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    t0 = time.time()
    log = kernels._finish_build("affine", *kernels._start_build(
        "affine", ("-Xptxas", "-v")))
    others = []
    for k, root in enumerate(args.root):
        mod = load_other(root, k)
        mod._load("affine")
        others.append(("other" if k == 0 else f"other{k}", mod))
    say(build_seconds=time.time() - t0, ptxas=[
        ln.strip() for ln in log.splitlines()
        if "registers" in ln or "spill" in ln or "Compiling" in ln],
        plan=kernels._AFFINE_PLAN, others=args.root,
        sm_count=torch.cuda.get_device_properties(0).multi_processor_count)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    dts = dict(f32=torch.float32, f64=torch.float64)
    for level in args.level:
        args.level_now = level
        prob = cylinderwake_problem(level=level, Re=100.0, charvel=0.2)
        for tname in args.tables:
            aff = prob.affine_ops(dts[tname], device=dev)
            for mode, cm, ca in MODES:
                if args.modes is None or mode in args.modes:
                    read_mode(kernels, others, prob, aff, mode, cm, ca, args,
                              gen)
        del prob
        torch.cuda.empty_cache()
    if args.wake3d:
        from chip_smoke import (WAKE3D, affine3d_bits_cases,
                                affine3d_bound_ms, affine_bits)
        from dolfin_navier_scipy_tpu_torch.models import (
            cylinderwake3d_problem)
        from dolfin_navier_scipy_tpu_torch.ops.affine import (
            AffineVectorOps)
        args.bound3d = affine3d_bound_ms
    for nz in args.wake3d:
        args.level_now = f"3D-2Z nz={nz}"
        prob = cylinderwake3d_problem(nz=nz, **WAKE3D)
        if nz == 2:
            cases = affine3d_bits_cases(prob, dev)
            bits = {tag: affine_bits(mod, cases) for tag, mod in others}
            bits["this"] = affine_bits(kernels, cases)
            say(phase="bits3d", nz=nz, bits=bits, same_as_this={
                tag: b == bits["this"] for tag, b in bits.items()})
            del cases
        for tname in args.tables:
            aff = AffineVectorOps.build(prob, dts[tname], full_dofs=True,
                                        device=dev)
            for mode, cm, ca in MODES:
                if args.modes is None or mode in args.modes:
                    read_mode(kernels, others, prob, aff, mode, cm, ca, args,
                              gen)
        del prob
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
