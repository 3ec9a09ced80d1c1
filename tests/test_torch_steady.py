"""The steady solver of the port vs the JAX package's on the CPU in f64:
``get_v_conv_conts``, the dense route (cavity), the host-sparse route and
the matrix-free Krylov route (wake level 0, Re 40, against the JAX
package's host-sparse fixed point: the bars of its own
``tests/test_steady_krylov.py``), one application of the Krylov route's
f32 preconditioner, the ``auto`` choice, and the pseudo-time march."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dolfin_navier_scipy_tpu.models import (
    cylinderwake_problem as jax_wake, drivencavity_problem as jax_cavity)
from dolfin_navier_scipy_tpu.solve import steady as jax_steady
from dolfin_navier_scipy_tpu.solve.convconts import (
    get_v_conv_conts as jax_conv_conts)
from dolfin_navier_scipy_tpu_torch.models import (
    cylinderwake_problem as torch_wake, drivencavity_problem as torch_cavity)
from dolfin_navier_scipy_tpu_torch.control import apply_robin_penalty
from dolfin_navier_scipy_tpu_torch.ops.kernels import elem_mv
from dolfin_navier_scipy_tpu_torch.solve import (
    expand_vp, get_bcinds, get_v_conv_conts, solve_steadystate_nse,
    solve_steadystate_pseudotime)
from dolfin_navier_scipy_tpu_torch.solve.steady import (
    SteadyKrylovKernel, _resolve_steady_linsolver, _sk_elem32, _sk_fmv,
    _sk_precond)

from torch_parity import align_native

torch.set_num_threads(1)
KW = dict(return_vp=True, return_nwtnupd_norms=True, verbose=False,
          vel_pcrd_stps=2, vel_nwtn_stps=8, vel_nwtn_tol=1e-12)


def _rel(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def wake0():
    """Wake level 0 at Re 40 in both packages and the JAX package's
    host-sparse fixed point (the oracle of both wake routes)."""
    align_native()
    jp = jax_wake(level=0, Re=40, charvel=0.2)
    tp = torch_wake(level=0, Re=40, charvel=0.2, device="cpu")
    (v, p), norms = jax_steady.solve_steadystate_nse(
        jp, linsolver="host-sparse", **KW)
    return jp, tp, (np.asarray(v), np.asarray(p), norms)


@pytest.fixture(scope="module")
def cavity8():
    align_native()
    return (jax_cavity(N=8, nu=1e-2),
            torch_cavity(N=8, nu=1e-2, device="cpu"))


@pytest.fixture(scope="module")
def cavity8_dense(cavity8):
    """The port's dense-route Newton solution on the cavity (``KW``)."""
    return solve_steadystate_nse(cavity8[1], linsolver="dense", **KW)


@pytest.mark.parametrize("mode", ["picard", "newton", "parts",
                                  "semi_explicit"])
def test_get_v_conv_conts_matches_jax(cavity8, mode):
    jp, tp = cavity8
    rng = np.random.default_rng(2)
    v = rng.normal(size=len(tp.invinds))
    kw = dict(Picard=mode == "picard", retparts=mode == "parts",
              semi_explicit=mode == "semi_explicit")
    out = get_v_conv_conts(vvec=v, prob=tp, device="cpu", **kw)
    ref = jax_conv_conts(vvec=v, prob=jp, **kw)
    for o, r in zip(out, ref):
        if mode == "parts":
            for oo, rr in zip(o, r):
                oo = oo.toarray() if hasattr(oo, "toarray") else oo
                rr = rr.toarray() if hasattr(rr, "toarray") else rr
                assert _rel(oo, rr) <= 1e-12
        elif o is None or np.isscalar(o):
            assert o == r
        else:
            o = o.toarray() if hasattr(o, "toarray") else o
            r = r.toarray() if hasattr(r, "toarray") else r
            assert _rel(o, r) <= 1e-12


def test_dense_route_matches_jax(cavity8, cavity8_dense):
    jp, tp = cavity8
    (vj, pj), nj = jax_steady.solve_steadystate_nse(jp, linsolver="dense",
                                                     **KW)
    (v, p), n = cavity8_dense
    assert v.shape == (tp.nv_full, 1) and p.shape == (tp.np_cond, 1)
    assert _rel(v, vj) <= 1e-10
    assert _rel(p, pj) <= 1e-8
    assert len(n) == len(nj) and _rel(n, nj) <= 1e-8
    # the lid, the pinned pressure's complement, the divergence
    assert np.isclose(v.reshape(-1, 2)[:, 0].max(), 1.0)
    assert np.abs(tp.Jc @ v.ravel()[tp.invinds]).max() < 1e-10
    # the dense matrix is rebuilt bit for bit
    sk = tp.steady_kernel()
    vf = sk.embed(torch.as_tensor(v.ravel()[tp.invinds]))
    assert torch.equal(sk.assemble(vf, False), sk.assemble(vf, False))
    vfull, pfull = expand_vp(tp, vp=np.concatenate(
        [v.ravel()[tp.invinds], -p.ravel()]))
    assert np.array_equal(vfull, v) and pfull.shape == (tp.np_cond + 1, 1)
    # starting Newton from the solution: one step, no update
    (v2, _), n2 = solve_steadystate_nse(tp, linsolver="dense",
                                        vel_start_nwtn=v, **KW)
    assert n2[0] < 1e-12 and _rel(v2, v) <= 1e-12


def test_host_route_matches_jax(wake0):
    _, tp, (vj, pj, nj) = wake0
    (v, p), n = solve_steadystate_nse(tp, linsolver="host-sparse", **KW)
    assert _rel(v, vj) <= 1e-10
    assert _rel(p, pj) <= 1e-8
    assert len(n) == len(nj)
    assert set(get_bcinds(tp, tp.geo.inflow_tag)) <= set(tp.bcinds)


def test_krylov_route_matches_the_jax_host_fixed_point(wake0):
    """The matrix-free route (f32 FGMRES inside f64 refinement) converges
    to the JAX package's host-sparse fixed point."""
    _, tp, (vj, pj, _) = wake0
    (v, p), n = solve_steadystate_nse(tp, linsolver="krylov", **KW)
    assert n and n[-1] < 1e-12
    assert _rel(v, vj) <= 1e-10
    assert _rel(p, pj) <= 1e-8


def test_krylov_preconditioner_matches_jax(wake0):
    """One f32 application of the block-triangular preconditioner (LSC
    pressure block, Jacobi-FGMRES velocity block)."""
    jp, tp, (vj, _, _) = wake0
    jsk = jax_steady.SteadyKrylovKernel(jp)
    sk = SteadyKrylovKernel(tp, device="cpu")
    assert (sk.f_iters, sk.f_cycles, sk.l_iters) == (
        jsk.f_iters, jsk.f_cycles, jsk.l_iters)
    assert sk.LinvT is not None and not sk.linv_pair
    vlin = vj.ravel()
    r = np.random.default_rng(4).normal(size=sk.nin + sk.npp)
    # the oracle as one compiled program (eager, its loops dispatch op by
    # op)
    jel, ref = jax.jit(lambda v, x: (
        lambda e: (e, jax_steady._sk_precond(jsk, e, x)))(
            jax_steady._sk_elem32(jsk, v, False)))(
        jnp.asarray(vlin), jnp.asarray(r, jnp.float32))
    el = _sk_elem32(sk, torch.as_tensor(vlin), False)
    # the port's F blocks: the JAX package's convection blocks plus the
    # stiffness's (the F-matvec is one element-block product)
    assert _rel(el.double(), np.asarray(jel, np.float64)
                + tp.elem_tensors["A"]) <= 1e-6
    out = _sk_precond(sk, el, torch.as_tensor(r, dtype=torch.float32))
    assert out.dtype == torch.float32
    assert _rel(out.double(), np.asarray(ref, np.float64)) <= 1e-5
    # one F-matvec a velocity-block iteration, one before it, one in the
    # pressure block
    assert sk.n_fmv == sk.f_cycles * (sk.f_iters + 1) + 1


@pytest.mark.parametrize("robin", [False, True])
def test_f_matvec_is_one_product_of_the_stiffness_and_convection_blocks(
        wake0, robin):
    """The port's F-matvec: one element-block product of ``E_N + E_A``
    (the stiffness's stored blocks, which carry the outflow facet terms,
    and with ``bccontrol=True`` the Robin penalty, as the affine
    stiffness's facet rows do) equals the JAX package's two terms, the
    affine ``A v`` plus the convection blocks' product, to 1e-13 in f64
    at the fixed point; ``_sk_elem32`` is that table in f32."""
    _, tp, (vj, _, _) = wake0
    if robin:
        tp = torch_wake(level=0, Re=40, charvel=0.2, bccontrol=True,
                        device="cpu")
        apply_robin_penalty(tp, palpha=1e-3)
    sk = SteadyKrylovKernel(tp, device="cpu")
    aff = tp.affine_ops(torch.float64, device="cpu")
    assert aff.fac_elem.shape[0] > 0
    vlin = torch.as_tensor(vj.ravel())
    en = sk.kern64.element_matrices(vlin, picard_only=False).reshape(
        -1, 12, 12)
    fe = en + torch.as_tensor(tp.elem_tensors["A"])
    x = torch.as_tensor(np.random.default_rng(7).normal(size=sk.nin))
    n0 = sk.n_fmv
    y = _sk_fmv(sk, fe, x)
    assert sk.n_fmv == n0 + 1
    ref = aff.a_matvec(x) + elem_mv(en, x, sk.ell_dofs, sk.ell_dofs)
    assert _rel(y, ref) <= 1e-13
    assert _rel(_sk_elem32(sk, vlin, False).double(), fe) <= 1e-6


def test_auto_picks_the_route_by_size_and_device():
    cpu, card = torch.device("cpu"), torch.device("cuda")

    def prob(n):
        return SimpleNamespace(invinds=np.arange(n - 100), np_cond=100)

    assert _resolve_steady_linsolver(prob(6000), "auto", cpu) == "dense"
    assert _resolve_steady_linsolver(prob(6001), "auto", cpu) \
        == "host-sparse"
    assert _resolve_steady_linsolver(prob(25000), "auto", card) == "dense"
    assert _resolve_steady_linsolver(prob(25001), "auto", card) == "krylov"
    assert _resolve_steady_linsolver(prob(99999), "host-sparse", card) \
        == "host-sparse"
    with pytest.raises(ValueError):
        _resolve_steady_linsolver(prob(10), "lu", cpu)
    # the velocity cache keywords (which raised until they were ported)
    # reach the cache before any route is resolved
    with pytest.raises(AttributeError, match="nu"):
        solve_steadystate_nse(prob(10), save_data=True)


def test_pseudotime_matches_jax(cavity8, cavity8_dense):
    """The pseudo-time march (CNAB on the dense route, short rounds) gives
    the JAX package's iterate after the same rounds, and approaches the
    Newton solution."""
    jp, tp = cavity8
    kw = dict(tol=2e-3, chunk=40, max_rounds=6, verbose=False,
              return_info=True, return_vp=True)
    (vj, pj), ij = jax_steady.solve_steadystate_pseudotime(jp, **kw)
    (v, p), info = solve_steadystate_pseudotime(tp, **kw)
    assert info["rounds"] == ij["rounds"] and info["dt"] == ij["dt"]
    assert info["converged"] == ij["converged"]
    assert np.allclose(info["rates"], ij["rates"], rtol=1e-8)
    assert _rel(v, vj) <= 1e-10
    assert _rel(p, pj) <= 1e-8
    (vn, _), _ = cavity8_dense
    assert _rel(v, vn) < 0.2
