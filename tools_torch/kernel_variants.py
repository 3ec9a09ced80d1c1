#!/usr/bin/env python3
"""Where the hand-written kernels' time goes, on one card.

    python3 tools_torch/kernel_variants.py [--reps 50] [--rounds 2]

Needs a CUDA card.  Builds ``csrc/*.cu`` (``-Xptxas -v``: registers,
spills), then prints the card and one JSON line per reading:

* ``vecmat`` at the two operand shapes of the main path (8794^2, CNAB full
  layout; 8016^2, ``sbdf2`` inner layout; f32, random, seeded): the kernel
  checked against ``x @ KT``, launch to launch and through a CUDA graph,
  and timed (CUDA events over ``--reps`` eager calls) beside ``torch.mv``
  and ``x @ KT`` in turns (``--rounds`` passes, every other one reversed);
  at 8794 columns a sweep over the number of rows beside the library's
  ``sum()`` over the same bytes (slope: the stream's rate; intercept: a
  call's cost beyond streaming), and the blocks' own timestamps (start,
  end of their units, grid barrier, end);
* the convection kernel on the level-1 wake's tables (f32 tables, f64
  state), fused and vector form: device time per call in a CUDA-graph
  replay, eager time per call, the host's time per call (no
  synchronisation inside the loop), the C launch alone (pointers
  prepared), and the blocks' timestamps (start, end of the element phase,
  after the grid barrier, end).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet


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


def graph_ms(fn, calls=20, replays=10):
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
    return events_ms(g.replay, replays) / calls


def host_us(fn, calls=500):
    """Host time per call: the loop is not synchronised inside."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def phases(run, trace, names, launches=20):
    """Means over ``launches`` of the blocks' timestamps (``trace``: 4 int64
    a block, zero for blocks the grid does not have), in us from the first
    block's start."""
    rows = []
    for _ in range(launches + 3):
        run()
        torch.cuda.synchronize()
        t = trace[trace[:, 0] != 0]
        t = (t - t[:, 0].min()).double().cpu() / 1e3
        rows.append([float(t[:, 0].max()), float(t[:, 1].min()),
                     float(t[:, 1].mean()), float(t[:, 1].max()),
                     float(t[:, 2].max()), float(t[:, 3].max())])
    return dict(zip(names, torch.tensor(rows[3:]).mean(0).tolist()))


def vecmat_part(kernels, gen, args):
    for n in (8794, 8016):
        KT = kernels.as_vecmat_operand(
            torch.randn((n, n), generator=gen), device="cuda")
        x = torch.randn(n, generator=gen).cuda()
        ref = kernels.vecmat_ref(x, KT)
        bound = 1e3 * 4 * (n * n + 2 * n) / HBM_BYTES_PER_S
        atol = 1e-5 * float(torch.linalg.vector_norm(x)) * float(
            KT.abs().max())
        row = dict(shape=[n, n])
        y = kernels._vecmat_launch(x, KT)
        torch.cuda.synchronize()
        row["max_abs_err"] = float((y - ref).abs().max())
        row["ok"] = row["max_abs_err"] <= atol + 1e-4 * float(
            ref.abs().max())
        row["bitwise_repeat"] = torch.equal(y, kernels._vecmat_launch(x, KT))
        row["graph_ms"] = graph_ms(lambda: kernels._vecmat_launch(x, KT))
        say(**row)
        KTt = KT.T
        timed = [("library_mv", lambda: torch.mv(KTt, x)),
                 ("plain", lambda: kernels.vecmat_ref(x, KT)),
                 ("kernel", lambda: kernels._vecmat_launch(x, KT))]
        for r in range(args.rounds):
            for name, fn in (timed if r % 2 == 0 else timed[::-1]):
                ms = events_ms(fn, args.reps)
                say(shape=[n, n], name=name, round=r, ms=ms, bound_ms=bound,
                    bound_share=bound / ms)
        del KT, KTt

    n = 8794
    for m in (1100, 2200, 4400, 8794):
        KT = kernels.as_vecmat_operand(
            torch.randn((m, n), generator=gen), device="cuda")
        x = torch.randn(m, generator=gen).cuda()
        flat = torch.as_strided(KT, (m * KT.stride(0),), (1,))
        for r in range(args.rounds):
            say(sweep=[m, n], name="kernel", round=r,
                ms=events_ms(lambda: kernels._vecmat_launch(x, KT),
                             args.reps),
                bytes=4 * m * KT.stride(0))
            say(sweep=[m, n], name="library_sum", round=r,
                ms=events_ms(lambda: flat.sum(), args.reps),
                bytes=4 * m * KT.stride(0))
        if m == n:
            tr = torch.zeros((kernels._sm_count(KT.device), 4),
                             dtype=torch.int64, device="cuda")
            say(trace=[m, n], **phases(
                lambda: kernels._vecmat_launch(x, KT, trace=tr), tr,
                ["last_block_start_us", "first_units_end_us",
                 "mean_units_end_us", "last_units_end_us",
                 "last_barrier_exit_us", "last_end_us"]))
        del KT, flat


def conv_part(kernels, gen, args):
    from dolfin_navier_scipy_tpu_torch.models import cylinderwake_problem
    from dolfin_navier_scipy_tpu_torch.ops.affine import AffineVectorOps
    prob = cylinderwake_problem(level=1, Re=100.0, charvel=0.2)
    t = prob.conv_kernel_on(torch.float32).tables
    aff = AffineVectorOps.build(prob, torch.float32, full_dofs=True)
    u = torch.randn(prob.nv_full, generator=gen, dtype=torch.float64).cuda()
    sym = bool(prob.gradvsymmtrc)
    forms = {
        "fused": dict(fused=True, nu=prob.nu, sym=sym, fac_elem=aff.fac_elem,
                      fac_vdofs=aff.fac_dofs),
        "vector": dict(fused=False)}
    wrappers = {
        "fused": lambda: kernels.conv_vector_amatvec(
            u, prob.nu, sym, t, aff.fac_elem, aff.fac_dofs),
        "vector": lambda: kernels.conv_vector(u, None, t)}
    lib = kernels._conv_lib()
    for form, kw in forms.items():
        def run(kw=kw):
            return kernels._conv_launch(form, t, u, None, **kw)
        out = run()
        stream = torch.cuda.current_stream().cuda_stream
        plan = t.kernel_plan(kw["fused"], u.dtype, kw.get("fac_elem"),
                             kw.get("fac_vdofs"), stream)
        p0 = out.data_ptr()
        p1 = p0 + (out.shape[0] - 1) * out.shape[1] * out.element_size()
        args_c = (plan.c, u.data_ptr(), None, p0, p1,
                  float(kw.get("nu", 0.0)), int(kw.get("sym", False)),
                  stream)
        say(convection=form, graph_ms=graph_ms(run),
            eager_ms=events_ms(run, 200), host_us=host_us(run),
            launch_only_host_us=host_us(
                lambda: lib.convection_th2d(*args_c)))
        tr = torch.zeros((4096, 4), dtype=torch.int64, device="cuda")
        plan.c.trace = tr.data_ptr()
        say(convection_trace=form, **phases(
            lambda: lib.convection_th2d(*args_c), tr,
            ["last_block_start_us", "first_phase1_end_us",
             "mean_phase1_end_us", "last_phase1_end_us",
             "last_barrier_exit_us", "last_end_us"]))
        plan.c.trace = None
        say(convection=form, wrapper="public", host_us=host_us(
            wrappers[form]), eager_ms=events_ms(wrappers[form], 200))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", choices=("vecmat", "convection"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_variants.py needs a CUDA card")
    from dolfin_navier_scipy_tpu_torch.ops import kernels
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    logs = kernels.build_all(extra_flags=("-Xptxas", "-v"))
    say(ptxas={name: [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln]
               for name, log in logs.items()})
    gen = torch.Generator().manual_seed(0)
    if args.only != "convection":
        vecmat_part(kernels, gen, args)
    if args.only != "vecmat":
        conv_part(kernels, gen, args)


if __name__ == "__main__":
    main()
