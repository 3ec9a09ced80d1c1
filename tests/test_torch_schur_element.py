"""The element-operator ("non-banded") path of the block-Schur solver in
the port vs the JAX package's on the CPU: the host setup in f64 (solves
and warm solves with residual rounds, to 1e-10), the device setup (X by
block PCG in f32, at the bars of ``test_torch_schur_device.py``), and the
banded gate's choice on each problem — a 2D cavity and the 3D box of
``tests/test_3d.py`` (the 3D-2Z wake's: ``tests/test_torch_3d.py``)."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

import dolfin_navier_scipy_tpu.solve.sadpnt as jsp
from dolfin_navier_scipy_tpu.mesh import unit_square as jax_square
from dolfin_navier_scipy_tpu.mesh.tetmesh import (
    extrude_trimesh as jax_extrude)
from dolfin_navier_scipy_tpu.models import drivencavity_problem as jax_cavity
from dolfin_navier_scipy_tpu.models.problem import (
    GeoSetup as JaxGeo, build_problem as jax_build)
from dolfin_navier_scipy_tpu.ops.banded_conv import (
    banded_wins as jax_banded_wins)
from dolfin_navier_scipy_tpu_torch.mesh import extrude_trimesh, unit_square
from dolfin_navier_scipy_tpu_torch.models import drivencavity_problem
from dolfin_navier_scipy_tpu_torch.models.problem import (
    GeoSetup, build_problem)
from dolfin_navier_scipy_tpu_torch.solve import SchurSaddleSolver

from torch_parity import align_native

torch.set_num_threads(1)
DT = 1e-3
_CACHE = {}


def _box(square, extrude, geo_cls, build, **kw):
    mesh = extrude(square(3), nz=3, height=1.0)
    geo = geo_cls(charlen=1.0, ppin=-1, wall_tags=[1, 2, 3, 4, 8, 9])
    return build(mesh, geo, nu=0.85, charvel=1.0, **kw)


def _probs(name):
    if name not in _CACHE:
        align_native()
        if name == "cavity":
            _CACHE[name] = (jax_cavity(N=6, Re=100),
                            drivencavity_problem(N=6, Re=100, device="cpu"))
        else:
            _CACHE[name] = (
                _box(jax_square, jax_extrude, JaxGeo, jax_build),
                _box(unit_square, extrude_trimesh, GeoSetup, build_problem,
                     device="cpu"))
    return _CACHE[name]


def _coeff(tp):
    return sps.csr_matrix(tp.Mc + 0.5 * DT * tp.Ac)


def _rel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("name", ["cavity", "box"])
def test_element_path_host_setup_matches_jax(name):
    """f64 work, host setup: the factors, ``solve`` with 0 and 1 residual
    rounds and ``solve_warm`` (warm start, 2 rounds) equal to the JAX
    package's to 1e-10; the solve within 1e-10 of the exact one."""
    jp, tp = _probs(name)
    F = _coeff(tp)
    ref = jsp.SchurSaddleSolver(coeff=F, jmat=jp.Jc, jmatT=jp.JTc,
                                dtype=jnp.float64, banded=False)
    slv = SchurSaddleSolver(F, tp.Jc, tp.JTc, dtype=torch.float64,
                            banded=False, device="cpu")
    assert not slv.banded and slv.setup == "host" and ref.Bblk is None
    assert slv.ncg == ref.ncg and slv.warm_size == ref.warm_size == slv.nv
    assert _rel(slv.XT, np.asarray(ref.XT)) <= 1e-12
    assert _rel(slv.SinvT.T, np.asarray(ref.Sinv)) <= 1e-12
    rng = np.random.default_rng(5)
    bv, bp = rng.standard_normal(slv.nv), rng.standard_normal(slv.np)
    exact = jsp.host_saddle_factorized(F, tp.Jc, tp.JTc)(bv, bp).ravel()
    tb = (torch.from_numpy(bv), torch.from_numpy(bp))
    for refine in (0, 1):
        ref.refine = refine
        got = slv.solve(*tb, refine=refine)
        assert _rel(got, ref.solve(jnp.asarray(bv), jnp.asarray(bp))) \
            <= 1e-10, refine
    assert _rel(got, exact) <= 1e-10
    y0 = rng.standard_normal(slv.nv)
    got, y = slv.solve_warm(*tb, torch.from_numpy(y0), niter=8, refine=2)
    want, yj = ref.solve_warm(jnp.asarray(bv), jnp.asarray(bp),
                              jnp.asarray(y0), niter=8, refine=2)
    assert _rel(got, want) <= 1e-10 and _rel(y, yj) <= 1e-10


def test_element_path_device_setup_matches_jax_and_host():
    """f32 work, ``setup="device"`` on the 3D box: X by block PCG (f32)
    within 1e-5 of its scale of the host's X and of the JAX package's
    device X; the solves within 1e-5 of the host setup's and, refined, of
    the JAX package's; unrefined, no further from the exact solution than
    the JAX package's (its S^-1 is an f32 inverse, the port's f64)."""
    jp, tp = _probs("box")
    F = _coeff(tp)
    ref = jsp.SchurSaddleSolver(coeff=F, jmat=jp.Jc, jmatT=jp.JTc,
                                dtype=jnp.float32, banded=False,
                                setup="device")
    dev = SchurSaddleSolver(F, tp.Jc, tp.JTc, banded=False, setup="device",
                            device="cpu")
    host = SchurSaddleSolver(F, tp.Jc, tp.JTc, banded=False, setup="host",
                             device="cpu")
    assert dev.setup == "device" and host.setup == "host"
    assert set(dev.setup_timing) == {"probes_s", "x_s", "s_s", "sinv_s"}
    xd, xh = dev.XT.numpy(), host.XT.numpy()
    xj = np.asarray(ref.XT)[: dev.np]
    scale = np.abs(xh).max()
    assert xd.dtype == np.float32 and xd.shape == xh.shape == xj.shape
    assert np.abs(xd - xh).max() <= 1e-5 * scale
    assert np.abs(xd - xj).max() <= 1e-5 * scale
    rng = np.random.default_rng(6)
    bv, bp = rng.standard_normal(dev.nv), rng.standard_normal(dev.np)
    exact = jsp.host_saddle_factorized(F, tp.Jc, tp.JTc)(bv, bp).ravel()
    tb = [torch.from_numpy(b).float() for b in (bv, bp)]
    for refine in (0, 1):
        ref.refine = refine
        got = dev.solve(*tb, refine=refine).double().numpy()
        assert _rel(got, host.solve(*tb, refine=refine).double().numpy()) \
            <= 1e-5
        want = np.asarray(ref.solve(jnp.asarray(bv, jnp.float32),
                                    jnp.asarray(bp, jnp.float32)))
        if refine:
            assert _rel(got, want) <= 1e-5
        else:
            assert _rel(got, exact) <= min(1e-5, _rel(want, exact))


def test_banded_gate_matches_jax():
    """``banded="auto"``: the JAX package's gate (band within 3 GB and the
    band stream predicted to beat the element pipeline, on its constants)
    takes the same route as the port's solver on each problem (the 3D
    wake's: ``tests/test_torch_3d.py``)."""
    for name in ("cavity", "box"):
        jp, tp = _probs(name)
        F = _coeff(tp)
        nvals = int(np.prod(tp.space.vdofs_of_cells().shape))
        est = jsp._banded_bandwidth_gb(F)
        want = est <= 3.0 and jax_banded_wins(est * 1e9, nvals=nvals,
                                              ndofs=F.shape[0])
        slv = SchurSaddleSolver(F, tp.Jc, tp.JTc, dtype=torch.float64,
                                index_nvals=nvals, winv=False,
                                device="cpu")
        assert slv.banded == want, name
