"""The port's discrete adjoint (``solve/adjoint.py: make_diff_cnab``) and
the differentiable kernel functions under it, on the CPU in f64.

Twins of ``tests/test_adjoint.py`` (cavity ``N=8``, ``nu=1e-2``, from its
steady state, 12 steps forced along its actuation direction): the
gradients of the terminal kinetic energy in the control schedule and in
the initial state (one reverse pass of each package) and the
forward-mode derivative equal ``jax.grad`` / ``jax.jvp`` of the JAX
package's ``make_diff_cnab`` to 1e-10 relative, and the gradient matches
central finite differences.  The JAX package's simulator evaluates
the convection on its f32 tables under any work type; the port follows
the work type (f64 on the CPU, as both packages' ``cnab``).  So the JAX
problem is handed its f64 kernel in the f32 slot: both then compute the
same f64 map, whose derivatives are compared.

The ``torch.autograd.Function``\\ s of ``ops/kernels.py`` (the card's B1
and B5 with their backward kernels; on the CPU the same wrappers reach the
plain versions) are held to ``torch.autograd`` of the plain forward,
``conv_vjp_ref`` to ``jax.vjp`` of the JAX package's ``vector_and_amatvec``
with unsymmetric facet blocks, and the launches a gradient makes are
counted through the wrappers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dolfin_navier_scipy_tpu.models import (
    cylinderwake_problem as jax_wake, drivencavity_problem as jax_cavity)
from dolfin_navier_scipy_tpu.ops.affine import AffineVectorOps as JaxAffine
from dolfin_navier_scipy_tpu.solve.adjoint import (
    make_diff_cnab as jax_make_diff_cnab)
from dolfin_navier_scipy_tpu_torch.models import (
    cylinderwake_problem as torch_wake, drivencavity_problem as torch_cavity)
from dolfin_navier_scipy_tpu_torch.ops import kernels
from dolfin_navier_scipy_tpu_torch.ops.affine import AffineVectorOps
from dolfin_navier_scipy_tpu_torch.ops.kernels import (
    ConvAmatvecFn, ConvVectorFn, VecmatFn, conv_vector_amatvec_ref,
    conv_vector_ref, conv_vjp, conv_vjp_ref, vecmat_operand, vecmat_t,
    vecmat_t_ref)
from dolfin_navier_scipy_tpu_torch.solve import (
    make_diff_cnab, solve_steadystate_nse)

from torch_parity import align_native

torch.set_num_threads(1)
RTOL = 1e-10
DT, N_AMPS = 1e-3, 12


def _rel(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _kinetic(sim, Mc, v0):
    M = torch.as_tensor(Mc)

    def cost(amps, v=None):
        vT = sim(torch.as_tensor(v0) if v is None else v, amps)
        return 0.5 * vT @ (M @ vT)
    return cost


@pytest.fixture(scope="module")
def cavity():
    """Both packages' cavity, its steady state, the actuation direction of
    ``tests/test_adjoint.py``, both simulators, and both packages'
    gradients of the terminal kinetic energy in the schedule and in the
    initial state (one reverse pass each) after ``N_AMPS`` steps."""
    align_native()
    jp = jax_cavity(N=8, nu=1e-2)
    tp = torch_cavity(N=8, nu=1e-2, device="cpu")
    jp._conv_kernel_f32 = jp.conv_kernel      # see the module docstring
    vss = np.asarray(solve_steadystate_nse(
        tp, linsolver="host-sparse", vel_nwtn_tol=1e-12,
        verbose=False)).ravel()
    v0 = vss[tp.invinds]
    rng = np.random.default_rng(7)
    b = np.zeros(tp.nv_full)
    b[tp.invinds] = rng.normal(size=len(tp.invinds))
    b /= np.linalg.norm(b)
    Mc = tp.Mc.toarray()
    jsim = jax_make_diff_cnab(jp, DT, bvec=b)
    sim = make_diff_cnab(tp, DT, bvec=b, device="cpu")
    Mj = jnp.asarray(Mc)

    def jcost(v, amps):
        vT = jsim(v, amps)
        return 0.5 * vT @ (Mj @ vT)

    # one compiled program for the oracle (eager, its scan's steps would
    # dispatch op by op)
    jgrads = jax.jit(jax.grad(jcost, argnums=(0, 1)))(jnp.asarray(v0),
                                                      jnp.zeros(N_AMPS))
    amps = torch.zeros(N_AMPS, dtype=torch.float64, requires_grad=True)
    vt = torch.tensor(v0, requires_grad=True)
    _kinetic(sim, Mc, v0)(amps, vt).backward()
    return dict(jp=jp, tp=tp, v0=v0, b=b, Mc=Mc, jax=jsim, torch=sim,
                jgrads=[np.asarray(g) for g in jgrads],
                grads=[vt.grad, amps.grad])


def test_grad_in_the_schedule_matches_jax(cavity):
    gj = cavity["jgrads"][1]
    assert _rel(cavity["grads"][1], gj) <= RTOL
    assert np.all(np.isfinite(gj)) and np.all(np.abs(gj) > 0)


def test_grad_in_the_initial_state_matches_jax(cavity):
    assert _rel(cavity["grads"][0], cavity["jgrads"][0]) <= RTOL


def test_jvp_in_the_initial_state_matches_jax(cavity):
    c = cavity
    z = np.zeros(N_AMPS)
    d = np.random.default_rng(3).normal(size=len(c["v0"]))
    _, tj = jax.jit(lambda v, dv: jax.jvp(
        lambda x: c["jax"](x, jnp.asarray(z)), (v,), (dv,)))(
            jnp.asarray(c["v0"]), jnp.asarray(d))
    _, tt = torch.func.jvp(
        lambda v: c["torch"](v, torch.as_tensor(z)),
        (torch.as_tensor(c["v0"]),), (torch.as_tensor(d),))
    assert _rel(tt, tj) <= RTOL


def test_grad_matches_central_differences(cavity):
    """One schedule entry against the central difference, with the bar of
    ``tests/test_adjoint.py``."""
    c = cavity
    cost = _kinetic(c["torch"], c["Mc"], c["v0"])
    amps = torch.zeros(N_AMPS, dtype=torch.float64, requires_grad=True)
    cost(amps).backward()
    i, eps = N_AMPS // 2, 1e-4
    e = torch.zeros(N_AMPS, dtype=torch.float64)
    e[i] = eps
    with torch.no_grad():
        fd = float(cost(e) - cost(-e)) / (2 * eps)
    assert abs(float(amps.grad[i]) - fd) < 1e-4 * max(1.0, abs(fd))


_WRAPPERS = ("vecmat", "vecmat_t", "conv_vector", "conv_vector_amatvec",
             "conv_vjp")


@pytest.mark.parametrize("remat", [True, False])
def test_launches_per_gradient(cavity, monkeypatch, remat):
    """The calls a gradient in the schedule makes of each wrapper (the
    launches on the card, where ``chip_smoke.py`` asserts the same
    counts): the forward loop, remat's recomputation of each step, one
    backward of B1 a step and one of B5 a step but the first (its state
    does not depend on the schedule).  remat changes the counts, not the
    gradient."""
    c = cavity
    calls = dict.fromkeys(_WRAPPERS, 0)
    for name in _WRAPPERS:
        fn = getattr(kernels, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(kernels, name, counted)
    n = 5
    sim = make_diff_cnab(c["tp"], DT, bvec=c["b"], remat=remat,
                         device="cpu")
    amps = torch.zeros(n, dtype=torch.float64, requires_grad=True)
    _kinetic(sim, c["Mc"], c["v0"])(amps).backward()
    fwd = 2 * n if remat else n
    assert calls == dict(vecmat=fwd, vecmat_t=n, conv_vector=1,
                         conv_vector_amatvec=fwd, conv_vjp=n - 1)
    ref = torch.zeros(n, dtype=torch.float64, requires_grad=True)
    _kinetic(c["torch"], c["Mc"], c["v0"])(ref).backward()
    assert torch.equal(amps.grad, ref.grad)


@pytest.fixture(scope="module")
def wake_tables():
    """The wake at level 0 in both packages (outflow facet blocks), with
    seeded unsymmetric blocks on its facet dof table."""
    align_native()
    jp = jax_wake(level=0, Re=100)
    tp = torch_wake(level=0, Re=100, device="cpu")
    jaff = JaxAffine.build(jp, jnp.float64, full_dofs=True)
    taff = AffineVectorOps.build(tp, torch.float64, full_dofs=True,
                                 device="cpu")
    fe = np.random.default_rng(5).normal(size=taff.fac_elem.shape)
    assert fe.shape[0] > 0 and not np.allclose(fe, fe.transpose(0, 2, 1))
    return jp, tp, jaff, taff, fe


@pytest.mark.parametrize("sym", [True, False])
def test_conv_vjp_ref_matches_jax_vjp(wake_tables, sym):
    jp, tp, jaff, taff, fe = wake_tables
    rng = np.random.default_rng(6)
    u, gc, ga = rng.normal(size=(3, tp.nv_full))
    jk = jp.conv_kernel                  # built outside the traced function

    @jax.jit
    def jax_vjps(x, g1, g2):
        fused = jax.vjp(lambda y: jk.vector_and_amatvec(
            y, jp.nu, sym=sym, fac_elem=jnp.asarray(fe),
            fac_vdofs=jaff.fac_vdofs), x)[1]((g1, g2))[0]
        return fused, jax.vjp(jk.vector, x)[1](g1)[0]

    ref, ref_vec = jax_vjps(*map(jnp.asarray, (u, gc, ga)))
    t = tp.conv_kernel.tables
    got = conv_vjp_ref(*map(torch.as_tensor, (u, gc, ga)), tp.nu, sym, t,
                       torch.as_tensor(fe), taff.fac_dofs)
    assert _rel(got, ref) <= RTOL
    # the vector form (no stiffness cotangent): the VJP of N(u)u
    got = conv_vjp(torch.as_tensor(u), torch.as_tensor(gc), None, 0.0,
                   False, t)
    assert _rel(got, ref_vec) <= RTOL


def _plain_grads(f, x, gout, dx):
    """``(vjp, jvp)`` of ``f`` at ``x`` by torch.autograd / torch.func."""
    xr = x.clone().requires_grad_(True)
    out = f(xr)
    outs = out if isinstance(out, tuple) else (out,)
    gouts = gout if isinstance(gout, tuple) else (gout,)
    (g,) = torch.autograd.grad(outs, xr, gouts)
    return g, torch.func.jvp(f, (x,), (dx,))[1]


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return max(_rel(x, y) for x, y in zip(a, b))


def test_functions_match_autograd_of_the_plain_forward(wake_tables):
    """Backward and forward mode of ``VecmatFn``, ``ConvAmatvecFn`` and
    ``ConvVectorFn`` (the wiring the card runs) against autograd of the
    plain forward; ``VecmatFn`` on an unsymmetric operand."""
    _, tp, _, taff, fe = wake_tables
    rng = np.random.default_rng(8)
    t = tp.conv_kernel.tables
    fe = torch.as_tensor(fe)
    u, du, gc, ga = map(torch.as_tensor, rng.normal(size=(4, tp.nv_full)))
    cases = [
        (lambda x: ConvAmatvecFn.apply(x, tp.nu, True, t, fe, taff.fac_dofs),
         lambda x: conv_vector_amatvec_ref(x, tp.nu, True, t, fe,
                                           taff.fac_dofs), (gc, ga)),
        (lambda x: ConvVectorFn.apply(x, t),
         lambda x: conv_vector_ref(x, None, t), gc)]
    m, n = 37, 29
    KT = vecmat_operand(m, n, torch.float64, "cpu").copy_(
        torch.as_tensor(rng.normal(size=(m, n))))
    x, dx, g = (torch.as_tensor(rng.normal(size=k)) for k in (m, m, n))
    cases.append((lambda y: VecmatFn.apply(y, KT), lambda y: y @ KT, g))
    for fn, plain, gout in cases:
        x0, d0 = (x, dx) if gout is g else (u, du)
        got, want = _plain_grads(fn, x0, gout, d0), \
            _plain_grads(plain, x0, gout, d0)
        assert _same(got[0], want[0]) <= 1e-12
        assert _same(got[1], want[1]) <= 1e-12
    with pytest.raises(ValueError, match="KT"):
        VecmatFn.apply(x, KT.clone().requires_grad_(True))


def test_vecmat_t_is_the_exact_transpose():
    """``vecmat_t`` (the CPU path: its plain version) is ``KT @ g`` on the
    stored operand, which is far from symmetric here, not ``KT.T @ g``."""
    rng = np.random.default_rng(9)
    n = 33
    A = rng.normal(size=(n, n))
    A[np.triu_indices(n, 1)] *= 10.0
    KT = vecmat_operand(n, n, torch.float64, "cpu").copy_(torch.as_tensor(A))
    g = torch.as_tensor(rng.normal(size=n))
    want = A @ g.numpy()
    assert _rel(vecmat_t(g, KT), want) <= 1e-14
    assert _rel(vecmat_t_ref(g, KT), want) <= 1e-14
    assert _rel(KT.T @ g, want) > 0.5
    with pytest.raises(ValueError):
        vecmat_t(g[:-1], KT)
