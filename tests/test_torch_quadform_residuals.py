"""The quadratic convection tensor (``ops/quadform.py``) and the residual
verifiers (``residual_checks.py``) of the port vs the JAX package on the
CPU in f64, and the port's own integrator steps zeroing the host-assembled
IMEX residuals (twins of ``tests/test_quadform.py`` and
``tests/test_residuals.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dolfin_navier_scipy_tpu import residual_checks as jax_rc
from dolfin_navier_scipy_tpu.fem.dofmap import TaylorHoodSpace as JaxSpace
from dolfin_navier_scipy_tpu.mesh import unit_square as jax_square
from dolfin_navier_scipy_tpu.models import drivencavity_problem as jax_cavity
from dolfin_navier_scipy_tpu.ops import quadform as jax_qf
from dolfin_navier_scipy_tpu.ops.assemble import AssemblyContext as JaxCtx
from dolfin_navier_scipy_tpu_torch import residual_checks as rc
from dolfin_navier_scipy_tpu_torch.fem.dofmap import TaylorHoodSpace
from dolfin_navier_scipy_tpu_torch.mesh import unit_square
from dolfin_navier_scipy_tpu_torch.models import (
    drivencavity_problem as torch_cavity)
from dolfin_navier_scipy_tpu_torch.ops import quadform as qf
from dolfin_navier_scipy_tpu_torch.ops.assemble import AssemblyContext
from dolfin_navier_scipy_tpu_torch.ops.convection import ConvectionKernel
from dolfin_navier_scipy_tpu_torch.solve import cnab, solve_steadystate_nse

from torch_parity import align_native

torch.set_num_threads(1)
_CACHE = {}


def _ctx():
    """Both packages' assembly contexts on the unit square (N=4), and two
    random full velocity fields."""
    if "ctx" not in _CACHE:
        align_native()
        jctx = JaxCtx(JaxSpace(jax_square(4)))
        tctx = AssemblyContext(TaylorHoodSpace(unit_square(4)))
        rng = np.random.default_rng(8)
        nv = tctx.space.nv_full
        _CACHE["ctx"] = (jctx, tctx, rng.normal(size=nv),
                         rng.normal(size=nv))
    return _CACHE["ctx"]


def _maxrel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / np.abs(b).max()


def test_element_tensors_and_exported_H_equal_jax():
    jctx, tctx, v, u = _ctx()
    hel = qf.quad_tensor_elements(tctx)
    assert hel.shape == (tctx.wdet.shape[0], 6, 6, 12)
    assert _maxrel(hel, jax_qf.quad_tensor_elements(jctx)) <= 1e-14
    H = qf.ass_convmat_asmatquad(tctx)
    JH = jax_qf.ass_convmat_asmatquad(jctx)
    assert H.shape == JH.shape and H.nnz == JH.nnz
    assert abs(H - JH).max() <= 1e-14 * abs(JH).max()
    # the export contract: H kron(w, u) = (u.grad) w
    ref = jax_qf.QuadConvOp.from_ctx(jctx).vector(jnp.asarray(v),
                                                  jnp.asarray(u))
    assert _maxrel(H @ np.kron(v, u), ref) <= 1e-12


def test_quadop_vector_matches_jax_and_the_kernel():
    jctx, tctx, v, u = _ctx()
    op = qf.QuadConvOp.from_ctx(tctx, device="cpu")
    jop = jax_qf.QuadConvOp.from_ctx(jctx)
    kern = ConvectionKernel(tctx, device="cpu")
    tv, tu = torch.from_numpy(v), torch.from_numpy(u)
    for args, jargs in (((tv, tu), (v, u)), ((tv,), (v,))):
        out = op.vector(*args)
        assert out.dtype == torch.float64 and out.shape == (len(v),)
        ref = jop.vector(*[jnp.asarray(a) for a in jargs])
        assert _maxrel(out, ref) <= 1e-12
        assert _maxrel(out, kern.vector(*args).numpy()) <= 1e-12
        # the fixed-order sums give the same bits again
        assert torch.equal(op.vector(*args), out)


def test_quadop_linearized_matches_jax_and_the_element_matrices():
    jctx, tctx, v, _ = _ctx()
    op = qf.QuadConvOp.from_ctx(tctx, device="cpu")
    elems = op.linearized(torch.from_numpy(v))
    assert elems.shape == (tctx.wdet.shape[0], 6, 2, 6, 2)
    ref = jax_qf.QuadConvOp.from_ctx(jctx).linearized(jnp.asarray(v))
    assert _maxrel(elems, ref) <= 1e-12
    kern = ConvectionKernel(tctx, device="cpu")
    assert _maxrel(elems, kern.element_matrices(
        torch.from_numpy(v)).numpy()) <= 1e-12


def _cavity():
    """Both packages' cavity (N=7, nu=1e-2), the port's steady state and a
    short port CNAB run from a perturbed start (the JAX test's set-up)."""
    if "cavity" not in _CACHE:
        align_native()
        jp = jax_cavity(N=7, nu=1e-2)
        tp = torch_cavity(N=7, nu=1e-2, device="cpu")
        v, p = solve_steadystate_nse(tp, return_vp=True,
                                     linsolver="host-sparse",
                                     vel_nwtn_tol=1e-13)
        v0 = v.ravel()[tp.invinds] * (1 + 0.02)
        trange = np.linspace(0, 0.02, 5)
        out = cnab(trange=trange, prob=tp, inivel=v0, save_every=1,
                   predictor="IMEX-Euler", linsolver="dense", device="cpu")
        _CACHE["cavity"] = (jp, tp, v.ravel(), p.ravel(), v0, trange, out)
    return _CACHE["cavity"]


def test_steady_state_residuals_match_jax():
    jp, tp, v, p, *_ = _cavity()
    res, jres = rc.get_steady_state_res(tp), jax_rc.get_steady_state_res(jp)
    R = res(v, p)
    assert _maxrel(R, jres(v, p)) <= 1e-12
    assert np.abs(R[tp.invinds]).max() < 1e-10
    # the test-function functional, and tensors taken as inputs
    phi = np.random.default_rng(2).normal(size=tp.nv_full)
    assert res(torch.from_numpy(v), p, phi) == pytest.approx(
        jres(v, p, phi), rel=1e-12)
    prj = rc.prjctd_steadystate_res(tp, v)
    assert _maxrel(prj, jax_rc.prjctd_steadystate_res(jp, v)) <= 1e-12


@pytest.mark.parametrize("transposed", [False, True])
def test_app_prj_via_sadpnt_matches_jax(transposed):
    _, tp, *_ = _cavity()
    rhs = np.random.default_rng(3).normal(size=len(tp.invinds))
    kw = dict(amat=tp.Mc, jmat=tp.Jc, jmatT=tp.JTc, transposedprj=transposed)
    out = rc.app_prj_via_sadpnt(rhsv=rhs, **kw)
    assert _maxrel(out, jax_rc.app_prj_via_sadpnt(rhsv=rhs, **kw)) <= 1e-12
    if not transposed:
        # a projection: J w = 0
        assert np.abs(tp.Jc @ out.ravel()).max() <= 1e-12 * np.abs(
            out).max()


def _imex_args(scheme):
    """The arguments of a scheme's residual: the port's own bootstrap
    (IMEX-Euler predictor, Heun corrector) and first AB2 step."""
    _, tp, _, _, v0, trange, out = _cavity()
    bs = out["bootstrap"]

    def full(x):
        return tp.embed(x).numpy()

    if scheme == "eule":
        return (full(v0), full(bs["v_pred"]), bs["p_pred"])
    if scheme == "heun":
        return (full(v0), full(bs["v_pred"]), full(bs["v"]), bs["p"])
    return (full(v0), full(bs["v"]), full(out["vs"][0]), out["ps"][0])


@pytest.mark.parametrize("scheme", ["eule", "heun", "abtw"])
def test_the_port_steps_zero_the_imex_residuals(scheme):
    """The port's integrator steps against the independently host-assembled
    weak form at the JAX test's bar; and each residual function equal to
    the JAX package's on the same (random) inputs."""
    jp, tp, _, _, _, trange, _ = _cavity()
    dt = trange[1] - trange[0]
    args = _imex_args(scheme)
    res = rc.get_imex_res(tp, dt, scheme=scheme)
    r = res(*args)
    assert np.abs(r).max() < 1e-11, np.abs(r).max()
    rng = np.random.default_rng(4)
    rand = [rng.normal(size=np.shape(a)) for a in args]
    assert _maxrel(res(*rand), jax_rc.get_imex_res(jp, dt, scheme=scheme)(
        *rand)) <= 1e-12
    with pytest.raises(ValueError):
        rc.get_imex_res(tp, dt, scheme="rk4")
