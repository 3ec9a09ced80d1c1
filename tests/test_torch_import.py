"""The port stands alone: it imports without jax and without the JAX
package, and its entry points default to the CUDA card."""

import os
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "dolfin_navier_scipy_tpu_torch")


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(PORT):
        files += [os.path.join(base, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    return sorted(files)


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = ("import sys, dolfin_navier_scipy_tpu_torch as t; "
            "import dolfin_navier_scipy_tpu_torch.utils.convert; "
            "import dolfin_navier_scipy_tpu_torch.models.functionals; "
            "import dolfin_navier_scipy_tpu_torch.solve.timeint; "
            "import dolfin_navier_scipy_tpu_torch.solve.steady; "
            "import dolfin_navier_scipy_tpu_torch.solve.krylov; "
            "import dolfin_navier_scipy_tpu_torch.solve.krylov_saddle; "
            "import dolfin_navier_scipy_tpu_torch.solve.convconts; "
            "import dolfin_navier_scipy_tpu_torch.ops.elementop; "
            "import dolfin_navier_scipy_tpu_torch.ops.banded_conv; "
            "import dolfin_navier_scipy_tpu_torch.ops.quadform; "
            "import dolfin_navier_scipy_tpu_torch.solve.newton_ti; "
            "import dolfin_navier_scipy_tpu_torch.residual_checks; "
            "from dolfin_navier_scipy_tpu_torch.solve import sbdf2, "
            "semi_implicit_euler; "
            "from dolfin_navier_scipy_tpu_torch.ops.kernels import "
            "conv_vector, conv_vector_amatvec, elem_mv, conv_quad; "
            "from dolfin_navier_scipy_tpu_torch.solve import "
            "solve_nse_newton_ti; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'dolfin_navier_scipy_tpu' or "
            "m.startswith('dolfin_navier_scipy_tpu.')]; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_names_jax_or_the_jax_package(path):
    text = open(path).read()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    # the port's own name starts with the JAX package's: only a following
    # '.' or whitespace/newline makes it the JAX package
    assert not re.search(
        r"^\s*(import|from)\s+dolfin_navier_scipy_tpu(\.|\s)", text, re.M)
    assert "dolfin_navier_scipy_tpu." not in text.replace(
        "dolfin_navier_scipy_tpu_torch.", "")


def test_tf32_is_off_after_import():
    import dolfin_navier_scipy_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_default_device_is_the_card_or_raises():
    from dolfin_navier_scipy_tpu_torch import default_device, resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)


def test_entry_points_do_not_fall_back_to_the_cpu():
    """``device=None`` means the card: without one every entry point and
    constructor raises instead of quietly running on the host."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    from dolfin_navier_scipy_tpu_torch.models import drivencavity_problem
    from dolfin_navier_scipy_tpu_torch.ops.affine import AffineVectorOps
    from dolfin_navier_scipy_tpu_torch.ops.convection import ConvectionKernel
    from dolfin_navier_scipy_tpu_torch.models import make_inscan_liftdrag
    from dolfin_navier_scipy_tpu_torch.solve import (
        InverseSaddleSolver, cnab, get_pfromv, sbdf2, semi_implicit_euler,
        solve_nse)
    from dolfin_navier_scipy_tpu_torch.utils.convert import carry_from_jax
    from dolfin_navier_scipy_tpu_torch.solve.timeint import _build_ops

    prob = drivencavity_problem(N=4, Re=50)
    calls = [
        lambda: solve_nse(prob=prob, t0=0., tE=0.1, Nts=4,
                          start_ssstokes=True, linsolver="dense"),
        lambda: cnab(trange=[0., .1, .2], prob=prob,
                     inivel=[0.] * len(prob.invinds), linsolver="dense"),
        lambda: solve_nse(prob=prob, t0=0., tE=0.1, Nts=4,
                          start_ssstokes=True, linsolver="dense",
                          time_int_scheme="sbdf2"),
        lambda: sbdf2(trange=[0., .1, .2], prob=prob,
                      inivel=[0.] * len(prob.invinds), linsolver="dense"),
        lambda: semi_implicit_euler(trange=[0., .1, .2], prob=prob,
                                    inivel=[0.] * len(prob.invinds),
                                    linsolver="dense"),
        lambda: make_inscan_liftdrag(prob, 0.1, charvel=1.0),
        lambda: carry_from_jax(dict(v=[0.])),
        lambda: _build_ops(prob, 0.1, 0.5, linsolver="dense"),
        lambda: ConvectionKernel(prob.ctx),
        lambda: AffineVectorOps.build(prob),
        lambda: InverseSaddleSolver(prob.Mc, prob.Jc, prob.JTc),
        lambda: get_pfromv(v=[0.] * len(prob.invinds), prob=prob),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
