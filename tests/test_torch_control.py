"""The control slice of the port vs the JAX package on the CPU in f64: the
Robin facet operators and their penalty, the observation operator, the LTI
observer discretizations, the Sherman-Morrison-Woodbury solvers, and
``cnab`` / ``sbdf2`` with Dirichlet controls, Robin control through
``f_tdp`` and static feedback (``umat``/``vmat``) on the dense and the
block-Schur solver (inner state layout); a controlled JAX carry resumed in
the port; the initial pressure read by the controls."""

import copy
import math

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from dolfin_navier_scipy_tpu.control import (
    apply_robin_penalty as jax_robin, get_heunab_lti as jax_heunab,
    get_heuntrpz_lti as jax_heuntrpz)
from dolfin_navier_scipy_tpu.models import (
    cylinderwake_problem as jax_wake, drivencavity_problem as jax_cavity)
from dolfin_navier_scipy_tpu.models.functionals import (
    observation_operator as jax_obs)
from dolfin_navier_scipy_tpu.ops.affine import AffineVectorOps as JaxAffine
from dolfin_navier_scipy_tpu.solve import timeint as jax_ti
from dolfin_navier_scipy_tpu.solve.sadpnt import SMWSolver as JaxSMW
from dolfin_navier_scipy_tpu.solve.timeint import _build_ops as jax_build_ops
from dolfin_navier_scipy_tpu_torch.control import (
    apply_robin_penalty, get_heunab_lti, get_heuntrpz_lti)
from dolfin_navier_scipy_tpu_torch.models import (
    cylinderwake_problem as torch_wake, drivencavity_problem as torch_cavity,
    observation_operator)
from dolfin_navier_scipy_tpu_torch.ops.affine import AffineVectorOps
from dolfin_navier_scipy_tpu_torch.solve import (
    DirichletControl, SaddleSolver, SMWSolver, apply_massinv, cnab, sbdf2,
    solve_sadpnt, solve_sadpnt_host, solve_steadystate_nse)
from dolfin_navier_scipy_tpu_torch.solve.timeint import _build_ops
from dolfin_navier_scipy_tpu_torch.utils.convert import carry_from_jax

from torch_parity import align_native

torch.set_num_threads(1)
# f64 work, the same algorithm: round-off apart
RTOL = 1e-10
# the Schur solver keeps f32 blocks under f64 work; its W is f32-built
RTOL_W = 1e-6
NTS, DT = 12, 0.005
TRANGE = np.linspace(0.0, NTS * DT, NTS + 1)
# the observation box behind the cylinder of the DFG wake
WAKE_BOX = dict(xmin=0.3, xmax=0.5, ymin=0.1, ymax=0.3)
_CACHE = {}


def _probs(name):
    """Problem pairs: 'rot' (the rotating-cylinder control), 'robin' (two
    Robin arcs, penalized), 'wake' (plain), 'cavity'."""
    if name not in _CACHE:
        align_native()
        if name == "cavity":
            pair = (jax_cavity(N=8, Re=100),
                    torch_cavity(N=8, Re=100, device="cpu"))
        else:
            kw = dict(level=0, Re=100, charvel=0.2,
                      movingwallcntrl=name == "rot",
                      bccontrol=name == "robin")
            pair = (jax_wake(**kw), torch_wake(device="cpu", **kw))
        if name == "robin":
            pair = pair + (jax_robin(pair[0], palpha=1e-3),
                           apply_robin_penalty(pair[1], palpha=1e-3))
        _CACHE[name] = pair
    return _CACHE[name]


def _v0(name):
    """A Stokes start shared by both packages (inner dofs)."""
    key = ("v0", name)
    if key not in _CACHE:
        tp = _probs(name)[1]
        _CACHE[key] = solve_steadystate_nse(
            tp, only_stokes=True).ravel()[tp.invinds]
    return _CACHE[key]


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _spdiff(a, b):
    return abs(sps.csr_matrix(a) - sps.csr_matrix(b)).max()


def test_robin_operators_and_penalty_match_jax():
    jp, tp, jB, tB = _probs("robin")
    assert tp.Arob.shape == jp.Arob.shape and tp.Brob.shape[1] == 2
    assert _spdiff(tp.Arob, jp.Arob) <= 1e-12 * abs(jp.Arob).max()
    assert np.abs(tp.Brob - jp.Brob).max() <= 1e-12 * np.abs(jp.Brob).max()
    # the penalty: stiffness, element tensors, the scaled input columns
    assert _spdiff(tp.Ac, jp.Ac) <= 1e-12 * abs(jp.Ac).max()
    assert (np.abs(tp.elem_tensors["A"] - jp.elem_tensors["A"]).max()
            <= 1e-12 * np.abs(jp.elem_tensors["A"]).max())
    assert np.abs(tB - jB).max() <= 1e-12 * np.abs(jB).max()
    # the arcs are inner dofs: the penalty shows in the affine facet rows
    aff = tp.affine_ops(torch.float64, device="cpu")
    x = np.random.default_rng(2).normal(size=len(tp.invinds))
    assert _rel(aff.view("a").matvec(torch.from_numpy(x)), tp.Ac @ x) <= 1e-12
    jaff = JaxAffine.build(jp, jnp.float64)
    assert aff.fac_elem.shape == tuple(jaff.fac_elem.shape)


def test_robin_penalty_needs_bccontrol():
    with pytest.raises(ValueError, match="bccontrol"):
        apply_robin_penalty(_probs("wake")[1], palpha=1e-3)


def test_observation_operator_equal():
    for name, odcoo in (("cavity", None), ("wake", WAKE_BOX)):
        jp, tp = _probs(name)[:2]
        C = observation_operator(tp, odcoo=odcoo, ny=3)
        assert np.array_equal(C, jax_obs(jp, odcoo=odcoo, ny=3))
        assert C.shape == (6, tp.nv_full) and (C.sum(1) > 0).any()
    with pytest.raises(ValueError, match="observation domain"):
        observation_operator(_probs("wake")[1])


@pytest.mark.parametrize("disc", ["heunab", "heuntrpz"])
def test_lti_discretizations_match_jax_and_expm(disc):
    """The twin of the JAX package's test_lti_discretizations_match_expm,
    and the port's steps equal the JAX ones along the way (with an input
    this time)."""
    from scipy.linalg import expm

    hN = 3
    rng = np.random.default_rng(1)
    hA = -np.diag([1.0, 2.0, 3.0]) + 0.2 * rng.normal(size=(hN, hN))
    hB = 0.1 * rng.normal(size=(hN, 2))
    hC = np.eye(hN)
    x0 = np.array([1.0, -1.0, 0.5])
    dt, nsteps = 1e-3, 200
    kw = dict(constdt=dt) if disc == "heuntrpz" else {}
    mk, jmk = dict(heunab=(get_heunab_lti, jax_heunab),
                   heuntrpz=(get_heuntrpz_lti, jax_heuntrpz))[disc]
    for ys in (np.zeros(2), np.array([0.3, -0.2])):
        fn, mem = mk(hb=hB, ha=hA, hc=hC, inihx=x0, device="cpu", **kw)
        jfn, jmem = jmk(hb=hB, ha=hA, hc=hC, inihx=x0, **kw)
        modes = [(0.0, "init"), (dt, "heunpred"), (dt, "heuncorr")] + [
            (k * dt, "abtwo") for k in range(2, nsteps + 1)]
        for t, mode in modes:
            y, mem = fn(t, vc=torch.from_numpy(ys), memory=mem, mode=mode)
            jy, jmem = jfn(t, vc=jnp.asarray(ys), memory=jmem, mode=mode)
            assert np.abs(_np(y) - np.asarray(jy)).max() <= 1e-12, mode
        if not ys.any():
            exact = expm(hA * (nsteps * dt)) @ x0
            assert np.allclose(_np(y), exact, atol=1e-5)


def _ops(name, scheme, linsolver):
    """Both packages' operator bundles of a run (built once, shared by the
    tests that run that problem, scheme and solver)."""
    key = ("ops", name, scheme, linsolver)
    if key not in _CACHE:
        jp, tp = _probs(name)[:2]
        theta = 0.5 if scheme == "cnab" else 2.0 / 3.0
        _CACHE[key] = (
            jax_build_ops(jp, DT, theta=theta, linsolver=linsolver),
            _build_ops(tp, DT, theta=theta, linsolver=linsolver,
                       device="cpu"))
    return _CACHE[key]


def _feedback_mats(name, ny=2):
    tp = _probs(name)[1]
    C = observation_operator(tp, odcoo=None if name == "cavity" else
                             WAKE_BOX, ny=ny)[:, tp.invinds]
    return -0.5 * C.T, C


@pytest.mark.parametrize("linsolver", ["dense", "schur"])
def test_smw_solver_matches(linsolver):
    """SMW over the dense solver equals the host SMW solve; over the Schur
    solver (f32 blocks under f64 work) it equals the JAX package's SMW
    over its Schur solver and the host solve to the Schur solver's own
    accuracy."""
    jp, tp = _probs("wake")
    theta, dt = 0.5, DT
    U, V = _feedback_mats("wake")
    c = theta * dt
    jops, ops = _ops("wake", "cnab", linsolver)
    smw = SMWSolver(base=ops.solver, umat=U, vmat=V, c=c)
    rng = np.random.default_rng(4)
    bv, bp = rng.normal(size=len(tp.invinds)), rng.normal(size=tp.np_cond)
    got = smw.solve(torch.from_numpy(bv), torch.from_numpy(bp))
    coeff = tp.Mc + theta * dt * tp.Ac
    host = solve_sadpnt_host(amat=coeff, jmat=tp.Jc, jmatT=tp.JTc, rhsv=bv,
                             rhsp=bp, umat=c * U, vmat=V).ravel()
    if linsolver == "dense":
        assert _rel(got, host) <= RTOL
        return
    want = jax.jit(JaxSMW(base=jops.solver, umat=U, vmat=V, c=c).solve)(
        jnp.asarray(bv), jnp.asarray(bp))
    assert _rel(got, want) <= RTOL
    assert _rel(got, host) <= RTOL_W
    # refine rounds reach the base solve
    assert _rel(smw.solve(torch.from_numpy(bv), torch.from_numpy(bp),
                          refine=2), host) < _rel(got, host)


def test_lu_solver_and_one_shot_helpers():
    _, tp = _probs("cavity")
    U, V = _feedback_mats("cavity")
    rng = np.random.default_rng(6)
    bv, bp = rng.normal(size=len(tp.invinds)), rng.normal(size=tp.np_cond)
    coeff = sps.csr_matrix(tp.Mc + 0.01 * tp.Ac)
    host = solve_sadpnt_host(amat=coeff, jmat=tp.Jc, jmatT=tp.JTc, rhsv=bv,
                             rhsp=bp, umat=U, vmat=V)
    out, slv = solve_sadpnt(amat=coeff, jmat=tp.Jc, jmatT=tp.JTc, rhsv=bv,
                            rhsp=bp, umat=U, vmat=V, return_solver=True,
                            device="cpu")
    assert isinstance(slv, SaddleSolver) and out.shape == host.shape
    assert _rel(out, host) <= RTOL
    plain = solve_sadpnt(amat=coeff, jmat=tp.Jc, rhsv=bv, rhsp=bp,
                         device="cpu")
    assert _rel(plain, solve_sadpnt_host(amat=coeff, jmat=tp.Jc, rhsv=bv,
                                         rhsp=bp)) <= RTOL
    x = apply_massinv(tp.Mc, bv)
    assert np.abs(tp.Mc @ x - bv).max() <= 1e-10 * np.abs(bv).max()
    kry = solve_sadpnt(amat=coeff, jmat=tp.Jc, rhsv=bv, krylov="gmres",
                       krpslvprms=dict(tol=1e-12), device="cpu")
    assert np.abs(kry - solve_sadpnt_host(amat=coeff, jmat=tp.Jc,
                                          rhsv=bv)).max() <= 1e-7


def _rot_controls(stateful):
    """The rotating-cylinder control of both packages: ``sin(20 t)``
    times the tangent stencil; ``stateful``: a memory that grows by 0.05
    a call and damps the rate (it must survive a resume)."""
    jp, tp = _probs("rot")
    dofs, stencil = tp.dircntrl[0]
    jdofs, jstencil = jp.dircntrl[0]
    assert np.array_equal(dofs, jdofs) and np.allclose(stencil, jstencil)
    if stateful:
        def tf(t, v, p, mem, mode):
            mem = mem + 0.05
            return math.sin(20.0 * t) * torch.cos(mem), mem

        def jf(t, v, p, mem, mode):
            mem = mem + 0.05
            return jnp.sin(20.0 * t) * jnp.cos(mem), mem

        tm, jm = torch.tensor(0.0, dtype=torch.float64), jnp.asarray(0.0)
    else:
        def tf(t, v, p, mem, mode):
            return math.sin(20.0 * t), mem

        def jf(t, v, p, mem, mode):
            return jnp.sin(20.0 * t), mem

        tm = jm = None
    return ([DirichletControl(dofs, stencil, tf, tm)],
            [jax_ti.DirichletControl(jdofs, jstencil, jf, jm)])


def _case(case):
    """``(problem name, port kwargs, JAX kwargs, bar)`` of a controlled
    run."""
    if case == "dirichlet":
        tc, jc = _rot_controls(stateful=False)
        return "rot", dict(controls=tc), dict(controls=jc)
    if case == "robin":
        jp, tp, jB, tB = _probs("robin")
        tfv = torch.from_numpy(tp.fv.ravel())
        tdiff = torch.from_numpy((tB[:, 0] - tB[:, 1]).ravel())
        jfv = jnp.asarray(jp.fv.ravel())
        jdiff = jnp.asarray((jB[:, 0] - jB[:, 1]).ravel())
        return ("robin", dict(f_tdp=lambda t: tfv + math.sin(10 * t) * tdiff),
                dict(f_tdp=lambda t: jfv + jnp.sin(10 * t) * jdiff))
    U, V = _feedback_mats("wake")
    return "wake", dict(umat=U, vmat=V), dict(umat=U, vmat=V)


@pytest.mark.parametrize("scheme,case,linsolver", [
    ("cnab", "dirichlet", "dense"), ("cnab", "dirichlet", "schur"),
    ("sbdf2", "dirichlet", "dense"), ("sbdf2", "dirichlet", "schur"),
    ("cnab", "robin", "dense"), ("cnab", "robin", "schur"),
    ("cnab", "feedback", "dense"), ("cnab", "feedback", "schur"),
    ("sbdf2", "feedback", "dense"),
])
def test_controlled_runs_match_jax(scheme, case, linsolver):
    name, tkw, jkw = _case(case)
    jp, tp = _probs(name)[:2]
    kw = dict(trange=TRANGE, inivel=_v0(name), save_every=10,
              linsolver=linsolver)
    fn = dict(cnab=(cnab, jax_ti.cnab), sbdf2=(sbdf2, jax_ti.sbdf2))[scheme]
    jops, tops = _ops(name, scheme, linsolver)
    ref = fn[1](prob=jp, ops=jops, **kw, **jkw)
    out = fn[0](prob=tp, ops=tops, device="cpu", **kw, **tkw)
    tol = RTOL_W if linsolver == "schur" else RTOL
    assert not out["ffflag"] and not ref["ffflag"]
    for k in ("v", "p", "vs", "ps"):
        assert _rel(out[k], ref[k]) <= tol, k
    if case == "dirichlet":
        # the control dofs carry the prescribed values at the end
        cv = out["carry"]["cvals"]
        stencil = torch.from_numpy(np.asarray(tp.dircntrl[0][1]).ravel())
        assert torch.equal(cv, math.sin(20.0 * TRANGE[-1]) * stencil)
        assert _rel(cv, ref["carry"]["cvals"]) <= RTOL


def test_static_feedback_smw_equals_modified_operator():
    """Twin of the JAX package's test: cnab(umat, vmat) equals cnab on a
    problem whose stiffness is literally A - umat @ vmat (the sparse path:
    its element ops would encode the true A)."""
    _, tp = _probs("cavity")
    U, V = _feedback_mats("cavity")
    v0 = _v0("cavity")
    trange = np.linspace(0, 0.1, 41)
    out_fb = cnab(trange=trange, prob=tp, inivel=v0, umat=U, vmat=V,
                  save_every=None, linsolver="dense", device="cpu")
    tp2 = copy.copy(tp)
    tp2.Ac = sps.csr_matrix(np.asarray(tp.Ac.todense()) - U @ V)
    tp2.affine_ops = lambda *a, **k: None
    out_mod = cnab(trange=trange, prob=tp2, inivel=v0, save_every=None,
                   linsolver="dense", device="cpu")
    assert not out_fb["ffflag"] and not out_mod["ffflag"]
    assert np.abs(_np(out_fb["v"]) - _np(out_mod["v"])).max() <= 5e-11
    out_free = cnab(trange=trange, prob=tp, inivel=v0, save_every=None,
                    linsolver="dense", device="cpu")
    M = sps.csr_matrix(tp.Mc)

    def en(v):
        return float(_np(v) @ (M @ _np(v)))

    assert en(out_fb["v"]) < en(out_free["v"])


@pytest.mark.parametrize("scheme", ["cnab", "sbdf2"])
def test_controlled_jax_carry_resumes_in_port(scheme):
    """A stateful Dirichlet control run half the horizon in the JAX
    package, its carry (control memories and values included) resumed in
    the port for the rest, equals the port's uninterrupted run."""
    jp, tp = _probs("rot")
    v0 = _v0("rot")
    tc, jc = _rot_controls(stateful=True)
    fn = dict(cnab=(cnab, jax_ti.cnab), sbdf2=(sbdf2, jax_ti.sbdf2))[scheme]
    jops, tops = _ops("rot", scheme, "dense")
    kw = dict(inivel=v0, save_every=None)
    full = fn[0](trange=TRANGE, prob=tp, controls=tc, device="cpu",
                 ops=tops, **kw)
    h = NTS // 2
    half = fn[1](trange=TRANGE[:h + 1], prob=jp, controls=jc, ops=jops,
                 **kw)
    import jax

    carry = jax.tree_util.tree_map(np.asarray, half["carry"])
    rc = carry_from_jax(carry, device="cpu")
    assert torch.is_tensor(rc["cvals"]) and torch.is_tensor(rc["cmems"][0])
    tc2, _ = _rot_controls(stateful=True)
    res = fn[0](trange=TRANGE[h:], prob=tp, controls=tc2, resume_carry=rc,
                device="cpu", ops=tops, **kw)
    assert _rel(res["v"], full["v"]) <= 1e-12
    assert float(res["carry"]["cmems"][0]) == pytest.approx(
        float(full["carry"]["cmems"][0]), abs=1e-15)


def test_initial_pressure_is_read_by_controls():
    """``inip`` is what the controls see first (ROADMAP F6; the JAX
    package reads it so too, ``timeint.py:411-412``): a control that
    records the pressure of its 'init' call."""
    _, tp = _probs("rot")
    dofs, stencil = tp.dircntrl[0]

    def tf(t, v, p, mem, mode):
        return 0.0, (float(p.sum()) if mode == "init" else mem)

    inip = np.linspace(0.0, 1.0, tp.np_cond)
    kw = dict(trange=TRANGE[:3], inivel=_v0("rot"), save_every=None,
              ops=_ops("rot", "cnab", "dense")[1])
    outs = [cnab(prob=tp, controls=[DirichletControl(dofs, stencil, tf)],
                 inip=ip, device="cpu", **kw) for ip in (inip, None)]
    assert outs[0]["carry"]["cmems"][0] == pytest.approx(inip.sum(),
                                                         rel=1e-14)
    assert outs[1]["carry"]["cmems"][0] == 0.0


def test_continuity_rhs_of_the_f32_step():
    """In f32 work the inner step's continuity rhs is ``g_n - J v_c`` from
    the carried state (f64), so the solves' residuals do not add up; in
    f64 work it is the JAX package's ``g_n - g_c``."""
    from dolfin_navier_scipy_tpu_torch.solve.timeint import _continuity_rhs

    _, tp = _probs("rot")
    rng = np.random.default_rng(8)
    c = dict(v=torch.from_numpy(rng.normal(size=len(tp.invinds))),
             gp=torch.from_numpy(rng.normal(size=tp.np_cond)))
    g = torch.from_numpy(rng.normal(size=tp.np_cond))
    f64 = _continuity_rhs(tp, torch.float64, "cpu")(g, c)
    assert torch.equal(f64, g - c["gp"])
    f32 = _continuity_rhs(tp, torch.float32, "cpu")(g, c)
    assert f32.dtype == torch.float64
    assert _rel(f32, g.numpy() - tp.Jc @ c["v"].numpy()) <= 1e-14
