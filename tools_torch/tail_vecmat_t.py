#!/usr/bin/env python3
"""The banded convection tail's vector (B6) and the transposed inverse
apply ``vecmat_t`` of one checkout, on one card: their bits on seeded
inputs and their times.

    python3 tools_torch/tail_vecmat_t.py [--root CHECKOUT] [--part tail|vecmat_t]
                                         [--cu COPY.cu ...] [--rounds 2]

Needs a CUDA card.  Imports the package of ``--root`` (default this
checkout; e.g. a parent commit unpacked with ``git archive <commit> | tar
-x -C build/parent``), so run it once a checkout and compare the lines.
After the card's name and power limit it prints one JSON line a reading:

* ``tail``: at wake levels 1 and 2 (``cylinderwake_problem(level, Re=100,
  charvel=0.2)``, the default call's w-space kernel and bc tail,
  ``wspace_kernel``) the tail built with ``force``, its vector on the
  seeded state of ``tail_state``: ``bits`` (``digest``, the record
  ``chip_smoke.py`` holds as ``TAIL_BITS``), device kernels a call, ms a
  call in a CUDA-graph replay beside B5's vector on the same state;
* ``vecmat_t``: at 8794^2 and 31 061^2 f32 (the level-1 and level-2
  ``ZpT`` of the adjoint) on the seeded operand of ``seeded_operand`` and
  ``seeded(n, 2)``: the checkout's wrapper's ``bits`` (``VECMAT_T_BITS``),
  and ms a call (graph replay) in turns with ``torch.mv(KT, g)`` and each
  ``--cu`` copy of ``csrc/vecmat.cu`` (built with the checkout's flags,
  its ``vecmat_t_f32`` called through ctypes), each copy's bits beside;
  the grid the checkout launches (``vecmat_t_grid``, where it has one).

The seeded inputs and digests are ``seeded_inputs.py``'s, which
``chip_smoke.py`` shares.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from seeded_inputs import (  # noqa: E402
    digest, seeded, seeded_operand, tail_state, wspace_kernel)

# the two vecmat_t shapes: ZpT of the adjoint at wake levels 1 and 2
VECMAT_T_SHAPES = ((8794, 8794), (31061, 31061))
TAIL_LEVELS = (1, 2)
TAIL_RE, TAIL_CHARVEL, TAIL_DT = 100.0, 0.2, 1e-3


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
    """Device ms a call: ``calls`` calls captured in a CUDA graph on a side
    stream (after warm calls there: kernels' scratch is per stream)."""
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


def tail_part(args):
    from dolfin_navier_scipy_tpu_torch.models import cylinderwake_problem
    from dolfin_navier_scipy_tpu_torch.ops.banded_conv import (
        build_banded_conv_tail)
    dev = torch.device("cuda")
    for level in TAIL_LEVELS:
        prob = cylinderwake_problem(level=level, Re=TAIL_RE,
                                    charvel=TAIL_CHARVEL)
        kern, nin, vbc = wspace_kernel(prob, TAIL_DT, dev)
        tail = build_banded_conv_tail(kern, nin, vbc[nin:], force=True)
        v = tail_state(vbc, nin, level, dev)
        y = tail.vector(v).clone()
        torch.cuda.synchronize()
        b5 = kern.vector(v)
        ms = [(graph_ms(lambda: tail.vector(v)),
               graph_ms(lambda: kern.vector(v))) for _ in range(args.rounds)]
        say(part="tail", level=level, slot_rows=tail.slots.shape[0], nin=nin,
            nvals=tail.nvals, bits=digest(y),
            repeat_equal=torch.equal(y, tail.vector(v)),
            vs_b5=float((y[:nin] - b5[:nin].float()).abs().max()
                        / b5.abs().max()),
            ms=[a for a, _ in ms], b5_ms=[b for _, b in ms])
        del tail, kern, prob
        torch.cuda.empty_cache()


def build_copy(kernels, src, out_dir):
    """``src`` (a copy of ``csrc/vecmat.cu``) built with the checkout's
    flags into ``out_dir``; its ``vecmat_t_f32`` through ctypes."""
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, os.path.basename(src)[:-3] + ".so")
    subprocess.run([kernels._nvcc(), *kernels._NVCC_FLAGS,
                    *kernels._SOURCE_FLAGS["vecmat"], "-o", lib, src],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(lib)
    fn = so.vecmat_t_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def vecmat_t_part(args):
    from dolfin_navier_scipy_tpu_torch.ops import kernels
    dev = torch.device("cuda")
    copies = [(os.path.basename(c)[:-3],
               build_copy(kernels, os.path.abspath(c),
                          os.path.join(kernels.build_dir(), "copies")))
              for c in args.cu]
    for m, n in VECMAT_T_SHAPES:
        KT = seeded_operand(kernels, m, n, 1, dev)
        g = seeded(n, 2, dev, torch.float32)
        y = kernels.vecmat_t(g, KT)
        torch.cuda.synchronize()
        grid = (kernels.vecmat_t_grid(m) if hasattr(kernels, "vecmat_t_grid")
                else None)
        ref = kernels.vecmat_t_ref(g.double(), KT.double())
        say(part="vecmat_t", shape=[m, n], bits=digest(y), grid=grid,
            rel_err=float((y.double() - ref).abs().max() / ref.abs().max()))

        def run_copy(fn):
            out = torch.empty(m, dtype=torch.float32, device=dev)

            def call():
                err = fn(g.data_ptr(), KT.data_ptr(), out.data_ptr(), m, n,
                         KT.stride(0), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")
            return call, out

        timed = [("wrapper", lambda: kernels.vecmat_t(g, KT)),
                 ("torch.mv", lambda: torch.mv(KT, g))]
        for tag, fn in copies:
            call, out = run_copy(fn)
            call()
            torch.cuda.synchronize()
            say(part="vecmat_t", shape=[m, n], copy=tag, bits=digest(out))
            timed.append((tag, call))
        for r in range(args.rounds):
            for tag, fn in (timed if r % 2 == 0 else timed[::-1]):
                say(part="vecmat_t", shape=[m, n], version=tag, round=r,
                    ms=graph_ms(fn))
        del KT
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--part", choices=("tail", "vecmat_t"))
    ap.add_argument("--cu", nargs="*", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tail_vecmat_t.py needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.root))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    import dolfin_navier_scipy_tpu_torch as pkg
    say(root=os.path.abspath(args.root), package=os.path.dirname(
        pkg.__file__))
    if args.part != "vecmat_t":
        tail_part(args)
    if args.part != "tail":
        vecmat_t_part(args)


if __name__ == "__main__":
    main()
