#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and no network; takes no arguments.  It

1. builds every hand-written kernel from ``dolfin_navier_scipy_tpu_torch/
   csrc/`` (one ``nvcc`` per source, started together),
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it and at a ragged shape, and times kernel,
   plain version, the one-call library equivalent and the card's bound,
3. drives the main path through the user's entry points: the DFG 2D-2
   cylinder wake at level 1 (Re=100), Stokes start, 300 CNAB steps with the
   dense saddle-inverse solver via ``solve_nse`` — counting kernel launches
   from zero just before to just after,
4. repeats that run on the card (warm, for the loop's rate) and on the CPU
   in f64, and requires the card's final velocity within 1e-6 relative of
   the CPU's.

Every phase prints one JSON line; any failed phase raises, so the exit
code is non-zero and the final line is missing.  The last line is
``{"ok": true, "device": {...}}``, the one before it the ``kernels`` table.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
             "False); this script only runs on the card")

from dolfin_navier_scipy_tpu_torch.models import cylinderwake_problem
from dolfin_navier_scipy_tpu_torch.ops import kernels
from dolfin_navier_scipy_tpu_torch.ops.kernels import vecmat, vecmat_ref
from dolfin_navier_scipy_tpu_torch.solve import solve_nse

# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate
# and the f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

SEED = 0
LEVEL, RE, CHARVEL = 1, 100.0, 0.2
T0, TE, NTS, SAVE_EVERY = 0.0, 0.3, 300, 60
RAGGED = (2049, 1023)


def say(**kw):
    print(json.dumps(kw), flush=True)


def require(cond, msg):
    """A failed check ends the run (also under ``python -O``)."""
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps):
    """Mean device time of ``fn`` in ms (CUDA events around ``reps`` calls
    after a warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def vecmat_bound_ms(m, n, itemsize=4):
    """Least time for ``x (m,) @ KT (m, n)``: each input read once, the
    output written once, over the memory rate; 2mn operations over the f32
    rate.  Returns ``(ms, "bytes" | "operations")``."""
    t_bytes = itemsize * (m * n + m + n) / HBM_BYTES_PER_S
    t_ops = 2.0 * m * n / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_vecmat(x, KT, what, reps):
    """Kernel vs plain version on the same inputs, then the timings."""
    m, n = KT.shape
    y = vecmat(x, KT)
    torch.cuda.synchronize()
    ref = vecmat_ref(x, KT)
    # both sum m f32 products, in another order: each is off the exact sum
    # by about eps32 * ||x||_2 * rms|KT| (random-walk rounding), so 1e-5 *
    # ||x||_2 * max|KT| is ~100 such errors; rtol covers large entries
    atol = 1e-5 * float(torch.linalg.vector_norm(x)) * float(KT.abs().max())
    rtol = 1e-4
    err = (y - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp_min(atol)).max())
    if not bool((err <= atol + rtol * ref.abs()).all()):
        raise AssertionError(
            f"vecmat kernel disagrees with vecmat_ref at {what} {(m, n)}: "
            f"max abs err {max_abs:.3e} (atol {atol:.3e}, rtol {rtol})")
    if not torch.equal(y, vecmat(x, KT)):
        raise AssertionError("vecmat kernel is not reproducible run to run")
    KTt = KT.T                      # what the one-call library form takes
    bound, by = vecmat_bound_ms(m, n, KT.element_size())
    out = dict(shape=[m, n], operand=what, dtype=str(KT.dtype),
               max_abs_err=max_abs, max_rel_err=max_rel, atol=atol,
               rtol=rtol,
               ms=time_ms(lambda: vecmat(x, KT), reps),
               plain_ms=time_ms(lambda: vecmat_ref(x, KT), reps),
               library_ms=time_ms(lambda: torch.mv(KTt, x), reps),
               bound_ms=bound, bound_by=by)
    out["roofline_share"] = bound / out["ms"]
    return out


def main():
    t_start = time.time()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say(phase="versions", python=sys.version.split()[0],
        torch=torch.__version__, cuda=torch.version.cuda,
        sm_count=torch.cuda.get_device_properties(0).multi_processor_count)

    # -- 1. build every kernel from the sources in this checkout ----------
    t0 = time.time()
    logs = kernels.build_all(extra_flags=("-Xptxas", "-v"))
    say(phase="build", seconds=time.time() - t0, sources=sorted(logs),
        build_dir=kernels.build_dir(),
        ptxas=[ln for log in logs.values() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln][:24])

    # -- 2. the kernel against its plain version, on the card -------------
    prob = cylinderwake_problem(level=LEVEL, Re=RE, charvel=CHARVEL)
    n_main = prob.nv_full + prob.np_cond       # the padded inverse's side
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    checks = []
    # main-path shape (8-byte loads: n is even, not a multiple of 4), the
    # next multiple of 4 (16-byte loads at the same size), a ragged shape
    n4 = -(-n_main // 4) * 4
    for (m, n), what, reps in (((n_main, n_main), "random", 50),
                               ((n4, n4), "random", 50),
                               (RAGGED, "random", 200)):
        KT = torch.randn((m, n), generator=gen, dtype=torch.float32).to(dev)
        x = torch.randn(m, generator=gen, dtype=torch.float32).to(dev)
        checks.append(check_vecmat(x, KT, what, reps))
        del KT, x
    KT64 = torch.randn(RAGGED, generator=gen, dtype=torch.float64).to(dev)
    checks.append(check_vecmat(
        torch.randn(RAGGED[0], generator=gen, dtype=torch.float64).to(dev),
        KT64, "random", 200))
    del KT64
    say(phase="kernel_checks", vecmat=checks)

    # -- 3. the main path, through the user's entry points -----------------
    kw = dict(t0=T0, tE=TE, Nts=NTS, start_ssstokes=True,
              time_int_scheme="cnab", linsolver="dense",
              save_every=SAVE_EVERY)
    nsteps = NTS - 1          # the Heun bootstrap takes the first interval
    torch.cuda.reset_peak_memory_stats()
    vecmat.launches = 0
    t0 = time.time()
    out = solve_nse(prob=prob, **kw)           # device=None: the card
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = vecmat.launches

    nin, npc = len(prob.invinds), prob.np_cond
    nsaved = nsteps // SAVE_EVERY
    v, p = out["v"], out["p"]
    require(v.is_cuda and out["carry"]["v"].is_cuda, "the loop left the card")
    require(v.dtype == torch.float64
            and out["ops"].wdtype == torch.float32, "f32 work / f64 carry")
    require(tuple(v.shape) == (nin,) and tuple(p.shape) == (npc,)
            and tuple(out["vs"].shape) == (nsaved, nin)
            and tuple(out["ps"].shape) == (nsaved, npc), "output shapes")
    require(out["ffflag"] is False, "blow-up flag set")
    for k in ("v", "p", "vs", "ps"):
        require(bool(torch.isfinite(out[k]).all()), f"{k} not finite")
    # one dense apply per loop step and none in the setup (the Stokes
    # start, the pressure recovery and the Heun bootstrap are host splu)
    require(launches == nsteps,
            f"{launches} vecmat launches on the main path, not {nsteps}")
    vh = v.cpu().numpy()
    div = prob.Jc @ vh - prob.fp.ravel()
    div_scale = abs(prob.Jc) @ np.abs(vh)
    div_rel = float(np.abs(div).max() / div_scale.max())
    # each f32 increment solve leaves a divergence residual of f32 size
    # relative to |J||delta|; 300 of them stay far below 1e-6 of |J||v|
    require(div_rel <= 1e-6, f"divergence residual {div_rel:.3e}")
    loop_s = out["timing"]["loop_s"]
    say(phase="main_path", problem="cylinderwake level 1, Re 100",
        nv_full=prob.nv_full, nin=nin, np_cond=npc,
        cells=int(prob.space.mesh.num_cells), steps=nsteps,
        vecmat_launches=launches, vecmat_shape=[n_main, n_main],
        wall_seconds=wall, setup_seconds=out["timing"]["setup_s"],
        bootstrap_seconds=out["timing"]["bootstrap_s"],
        loop_seconds=loop_s, steps_per_s=nsteps / loop_s,
        ms_per_step=1e3 * loop_s / nsteps,
        divergence_residual_rel=div_rel,
        peak_device_mem_bytes=torch.cuda.max_memory_allocated())

    # the same call again, warm (the first loop pays one-off library
    # start-up inside its timing): the loop's rate to quote
    vecmat.launches = 0
    warm = solve_nse(prob=prob, **kw)
    require(vecmat.launches == nsteps, "launch count of the warm run")
    wl = warm["timing"]["loop_s"]
    say(phase="main_path_warm", steps=nsteps, loop_seconds=wl,
        steps_per_s=nsteps / wl, ms_per_step=1e3 * wl / nsteps,
        setup_seconds=warm["timing"]["setup_s"],
        bootstrap_seconds=warm["timing"]["bootstrap_s"],
        rel_diff_v_to_first_run=float(
            torch.linalg.vector_norm(warm["v"] - v)
            / torch.linalg.vector_norm(v)))
    del warm

    # the kernel once more on the operands of that run: the padded inverse
    # and a right-hand side of the size the loop feeds it
    fl = next(iter(prob._full_layouts.values()))
    x_run = torch.zeros(n_main, dtype=torch.float32, device=dev)
    mv = prob.full["M"] @ prob.embed(v).cpu().numpy()
    x_run[: prob.nv_full] = torch.as_tensor(mv.astype(np.float32),
                                            device=dev)
    run_check = check_vecmat(x_run, fl["ZpT"], "inverse of the run", 50)
    say(phase="kernel_check_run_operands", vecmat=run_check)

    # -- 4. the same call on the CPU in f64 ---------------------------------
    before = vecmat.launches
    t0 = time.time()
    ref = solve_nse(prob=prob, device="cpu", **kw)
    cpu_s = time.time() - t0
    require(vecmat.launches == before, "the CPU run launched the kernel")
    require(ref["ffflag"] is False, "blow-up flag set in the CPU run")

    def rel(a, b):
        a, b = a.cpu().double(), b.cpu().double()
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    errs = {k: rel(out[k], ref[k]) for k in ("v", "p", "vs", "ps")}
    # f32 increment solves under an f64 carry: the velocity holds 1e-6
    require(errs["v"] <= 1e-6 and errs["vs"] <= 1e-6,
            f"card vs CPU f64: {errs}")
    say(phase="reference", device="cpu f64", seconds=cpu_s,
        cpu_steps_per_s=nsteps / ref["timing"]["loop_s"], rel_err=errs)

    # -- the kernels table and the verdict ----------------------------------
    main_chk = checks[0]
    say(phase="done", total_seconds=time.time() - t_start)
    print(smi, flush=True)
    say(kernels=[dict(
        name="vecmat", route="cuda",
        source="dolfin_navier_scipy_tpu_torch/csrc/vecmat.cu",
        replaces="dolfin_navier_scipy_tpu/ops/pallas_kernels.py:31",
        launches=launches, shape=main_chk["shape"],
        max_abs_err=main_chk["max_abs_err"], ms=main_chk["ms"],
        plain_ms=main_chk["plain_ms"], bound_ms=main_chk["bound_ms"],
        bound_by=main_chk["bound_by"], library_ms=main_chk["library_ms"])])
    say(ok=True, device=dict(platform="gpu",
                             kind=torch.cuda.get_device_name(0),
                             count=torch.cuda.device_count()))


if __name__ == "__main__":
    main()
