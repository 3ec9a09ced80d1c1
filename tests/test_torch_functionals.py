"""Lift/drag/pressure-drop functionals of the port vs the JAX package on
the wake at level 0: the host evaluators in f64 and the in-loop
``[Cl, Cd, dp]`` series of the full-layout CNAB loop (f32 sums)."""

import numpy as np
import pytest
import torch

from dolfin_navier_scipy_tpu.models import (
    LiftDragSurfForce as JaxLiftDrag, cylinderwake_problem as jax_wake,
    pressure_drop as jax_pressure_drop)
from dolfin_navier_scipy_tpu.models.functionals import (
    make_inscan_liftdrag as jax_inscan)
from dolfin_navier_scipy_tpu.solve import cnab as jax_cnab
from dolfin_navier_scipy_tpu_torch.models import (
    LiftDragSurfForce, cylinderwake_problem as torch_wake,
    drivencavity_problem, make_inscan_liftdrag, pressure_drop)
from dolfin_navier_scipy_tpu_torch.solve import (
    cnab, solve_nse, solve_steadystate_nse)

from torch_parity import align_native

torch.set_num_threads(1)
CHARVEL = 0.2
_CACHE = {}


def _probs():
    if not _CACHE:
        align_native()
        _CACHE["p"] = (jax_wake(level=0, Re=100, charvel=CHARVEL),
                       torch_wake(level=0, Re=100, charvel=CHARVEL,
                                  device="cpu"))
    return _CACHE["p"]


def _state():
    """A Stokes state, perturbed so that lift and convection are there."""
    jp, tp = _probs()
    v, p = solve_steadystate_nse(tp, only_stokes=True, return_vp=True)
    rng = np.random.default_rng(31)
    v = v.ravel().copy()
    v[tp.invinds] *= 1 + 0.05 * rng.normal(size=len(tp.invinds))
    return v, p.ravel() * (1 + 0.05 * rng.normal(size=p.size))


def test_liftdrag_and_pressure_drop_match_jax():
    jp, tp = _probs()
    v, p = _state()
    jld, tld = JaxLiftDrag(jp), LiftDragSurfForce(tp)
    assert np.array_equal(tld.xdofs, jld.xdofs)
    assert np.array_equal(tld.ydofs, jld.ydofs)
    ref = jld.coefficients(v, p, charvel=CHARVEL, charlen=0.1)
    out = tld.coefficients(v, p, charvel=CHARVEL, charlen=0.1)
    assert abs(ref[1]) > 0.1                      # a real drag
    for a, b in zip(out, ref):
        assert abs(a - b) <= 1e-10 * max(1.0, abs(b))
    # tensors are taken as well as arrays
    out_t = tld.coefficients(torch.from_numpy(v), torch.from_numpy(p),
                             charvel=CHARVEL, charlen=0.1)
    assert out_t == out
    assert abs(tld.evatorque(v, p, (0.2, 0.2))
               - jld.evatorque(v, p, (0.2, 0.2))) <= 1e-10
    dp_ref = jax_pressure_drop(jp, p)
    assert abs(pressure_drop(tp, p) - dp_ref) <= 1e-10 * abs(dp_ref)
    assert pressure_drop(tp, torch.from_numpy(p)) == pressure_drop(tp, p)


def test_inloop_series_matches_jax_and_the_host_evaluators():
    jp, tp = _probs()
    v, _ = _state()
    dt, n = 1e-3, 16
    trange = np.linspace(0, n * dt, n + 1)
    jf, job = jax_inscan(jp, dt, charvel=CHARVEL)
    tf, tob = make_inscan_liftdrag(tp, dt, charvel=CHARVEL)
    assert set(tob) == set(job)
    for k in ("mx", "ay", "jtx", "wp"):
        assert tob[k].dtype == torch.float32
        assert np.array_equal(tob[k].numpy(), np.asarray(job[k]))
    kw = dict(trange=trange, inivel=v[tp.invinds], linsolver="dense",
              save_every=5)
    ref = jax_cnab(prob=jp, outfunc=jf, out_bundle=job, **kw)
    out = cnab(prob=tp, device="cpu", outfunc=tf, out_bundle=tob, **kw)
    outs, routs = out["outs"].numpy(), np.asarray(ref["outs"])
    assert outs.shape == (n - 1, 3) and outs.dtype == np.float32
    assert out["carry"]["v"].shape == (tp.nv_full,)      # the full layout
    # f32 dots of ~1e3 terms, summed in another order
    scale = np.abs(routs).max(axis=0)
    assert (np.abs(outs - routs).max(axis=0) <= 1e-5 * scale).all()
    assert np.array_equal(out["out_times"], trange[2:])
    # the hook changes nothing of the trajectory
    bare = cnab(prob=tp, device="cpu", **kw)
    assert torch.equal(bare["v"], out["v"]) and bare["outs"] is None
    # the pressure-drop column is the host functional of the saved p
    assert abs(outs[4, 2] - pressure_drop(tp, out["ps"][0])) <= 1e-5 * scale[2]


def test_inloop_series_through_solve_nse():
    _, tp = _probs()
    dt, n = 1e-3, 8
    tf, tob = make_inscan_liftdrag(tp, dt, charvel=CHARVEL)
    out = solve_nse(prob=tp, t0=0.0, tE=n * dt, Nts=n, start_ssstokes=True,
                    linsolver="dense", save_every=0, outfunc=tf,
                    out_bundle=tob, device="cpu")
    assert out["outs"].shape == (n - 1, 3)
    assert bool(torch.isfinite(out["outs"]).all())
    assert float(out["outs"][-1, 1]) > 0.1               # drag coefficient


def test_a_problem_without_a_body_has_no_liftdrag():
    cav = drivencavity_problem(N=4, Re=50, device="cpu")
    with pytest.raises(ValueError, match="lift/drag"):
        LiftDragSurfForce(cav)
    with pytest.raises(ValueError, match="lift/drag"):
        make_inscan_liftdrag(cav, 1e-3, charvel=1.0)
