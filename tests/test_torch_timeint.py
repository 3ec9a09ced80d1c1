"""The integrators of the port vs the JAX package on the CPU in f64:
``sbdf2``, ``semi_implicit_euler``, ``cnab`` with time-dependent right-hand
sides and a ``dynamic_rhs`` with memory, in-loop observables, and exact
resume — within the port and from a JAX carry."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dolfin_navier_scipy_tpu.models import (
    cylinderwake_problem as jax_wake, drivencavity_problem as jax_cavity)
from dolfin_navier_scipy_tpu.solve import solve_nse as jax_solve_nse
from dolfin_navier_scipy_tpu.solve import timeint as jax_ti
from dolfin_navier_scipy_tpu_torch.models import (
    cylinderwake_problem as torch_wake, drivencavity_problem as torch_cavity)
from dolfin_navier_scipy_tpu_torch.solve import (
    cnab, sbdf2, semi_implicit_euler, solve_nse)
from dolfin_navier_scipy_tpu_torch.utils.convert import carry_from_jax

from torch_parity import align_native

torch.set_num_threads(1)
RTOL = 1e-10
NTS, DT = 20, 0.01
TRANGE = np.linspace(0.0, NTS * DT, NTS + 1)
_CACHE = {}


def _probs(name):
    if name not in _CACHE:
        align_native()
        if name == "cavity":
            _CACHE[name] = (jax_cavity(N=8, Re=100),
                            torch_cavity(N=8, Re=100, device="cpu"))
        else:
            _CACHE[name] = (jax_wake(level=0, Re=100, charvel=0.2),
                            torch_wake(level=0, Re=100, charvel=0.2,
                                       device="cpu"))
    return _CACHE[name]


def _v0(name):
    """A Stokes start shared by both packages (inner dofs)."""
    key = ("v0", name)
    if key not in _CACHE:
        from dolfin_navier_scipy_tpu_torch.solve import solve_steadystate_nse

        tp = _probs(name)[1]
        _CACHE[key] = solve_steadystate_nse(
            tp, only_stokes=True).ravel()[tp.invinds]
    return _CACHE[key]


def _rel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _same(out, ref, keys=("v", "p", "vs", "ps")):
    for k in keys:
        assert _rel(out[k], ref[k]) <= RTOL, k


@pytest.mark.parametrize("name", ["cavity", "wake0"])
def test_sbdf2_matches_jax(name):
    jp, tp = _probs(name)
    kw = dict(t0=0.0, tE=NTS * DT, Nts=NTS, start_ssstokes=True,
              time_int_scheme="sbdf2", linsolver="dense", save_every=5)
    ref = jax_solve_nse(prob=jp, **kw)
    out = solve_nse(prob=tp, device="cpu", **kw)
    _same(out, ref, ("v", "p", "vs", "ps", "iniv", "inip"))
    assert out["ffflag"] is False and np.array_equal(out["times"],
                                                     ref["times"])
    assert set(out["carry"]) == {"v", "dv", "p", "nfc_p", "fv", "dfv",
                                 "drm", "gp", "flag"}
    assert out["carry"]["v"].shape == (len(tp.invinds),)
    assert out["vs"].shape[0] == (NTS - 1) // 5
    # sbdf2 and cnab are different schemes of the same order
    cn = solve_nse(prob=tp, device="cpu", **dict(kw, time_int_scheme="cnab"))
    assert 1e-8 < _rel(out["v"], cn["v"].numpy()) < 1e-2


@pytest.mark.parametrize("rhs", ["default", "convective"])
def test_semi_implicit_euler_matches_jax(rhs):
    jp, tp = _probs("cavity")
    v0 = _v0("cavity")
    jkw, tkw = {}, {}
    if rhs == "convective":
        jfv = jnp.asarray(jp.fv.ravel())
        jbc, jinv = jnp.asarray(jp.bc_full_vec()), jnp.asarray(jp.invinds)
        jkw["rhs_tv"] = lambda t, v: jfv * jnp.cos(3 * t) - \
            jp.conv_kernel.vector(jbc.at[jinv].set(v))[jinv]
        tfv = torch.from_numpy(tp.fv.ravel())
        tkw["rhs_tv"] = lambda t, v: tfv * np.cos(3 * t) - \
            tp.conv_kernel.vector(tp.embed(v))[tp.invinds]
    ref = jax_ti.semi_implicit_euler(trange=TRANGE[:11], prob=jp, inivel=v0,
                                     save_every=2, **jkw)
    out = semi_implicit_euler(trange=TRANGE[:11], prob=tp, inivel=v0,
                              save_every=2, linsolver="dense", device="cpu",
                              **tkw)
    _same(out, ref)
    assert np.array_equal(out["times"], ref["times"])
    assert out["vs"].shape == (5, len(tp.invinds))


def _forcing(prob, as_array, sin, cos):
    """Time-dependent rhs callables written once for both array libraries:
    ``f_tdp``, ``g_tdp`` and a ``dynamic_rhs`` whose memory (a running
    average of the state) feeds back into the force."""
    rng = np.random.default_rng(21)
    nin, npc = len(prob.invinds), prob.np_cond
    fv, fp = as_array(prob.fv.ravel()), as_array(prob.fp.ravel())
    pert = as_array(1e-2 * rng.normal(size=nin))
    pertp = as_array(1e-3 * rng.normal(size=npc))

    def f_tdp(t):
        return fv + sin(7 * t) * pert

    def g_tdp(t):
        return fp + sin(3 * t) * pertp

    def dynamic_rhs(t, vc=None, memory=None, mode=None):
        acc = 0.5 * memory["acc"] + 0.5 * vc
        return -0.05 * acc + cos(5 * t) * pert, dict(acc=acc)

    return dict(f_tdp=f_tdp, g_tdp=g_tdp, dynamic_rhs=dynamic_rhs,
                dynamic_rhs_memory=dict(acc=as_array(np.zeros(nin))))


def _jax_forcing(prob):
    return _forcing(prob, jnp.asarray, jnp.sin, jnp.cos)


def _torch_forcing(prob):
    return _forcing(prob, torch.from_numpy, math.sin, math.cos)


_ALL_RHS = ("f_tdp", "g_tdp", "dynamic_rhs", "dynamic_rhs_memory")


def _plain_run(scheme, predictor):
    """The port's cavity run without forcing (shared by the cases of one
    scheme and predictor)."""
    key = ("plain", scheme, predictor)
    if key not in _CACHE:
        kw = dict(trange=TRANGE, inivel=_v0("cavity"), linsolver="dense",
                  save_every=4)
        if predictor:
            kw["predictor"] = predictor
        _CACHE[key] = dict(cnab=cnab, sbdf2=sbdf2)[scheme](
            prob=_probs("cavity")[1], device="cpu", **kw)
    return _CACHE[key]


@pytest.mark.parametrize("scheme,predictor,only", [
    ("cnab", "IMEX-Euler", _ALL_RHS), ("cnab", "IMEX-trpz", _ALL_RHS),
    ("sbdf2", None, _ALL_RHS), ("sbdf2", None, ("g_tdp",)),
    ("cnab", "IMEX-Euler", ("f_tdp",)),
], ids=["cnab-euler", "cnab-trpz", "sbdf2", "sbdf2-g_only", "cnab-f_only"])
def test_time_dependent_rhs_and_dynamic_rhs_match_jax(scheme, predictor,
                                                      only):
    jp, tp = _probs("cavity")
    v0 = _v0("cavity")
    jf = {k: v for k, v in _jax_forcing(jp).items() if k in only}
    tf = {k: v for k, v in _torch_forcing(tp).items() if k in only}
    kw = dict(trange=TRANGE, inivel=v0, linsolver="dense", save_every=4)
    if predictor:
        kw["predictor"] = predictor
    ref = getattr(jax_ti, scheme)(prob=jp, **kw, **jf)
    out = dict(cnab=cnab, sbdf2=sbdf2)[scheme](prob=tp, device="cpu", **kw,
                                               **tf)
    _same(out, ref)
    # a time-dependent rhs takes the inner layout, and it did matter
    assert out["carry"]["v"].shape == (len(tp.invinds),)
    plain = _plain_run(scheme, predictor)
    assert _rel(out["v"], plain["v"].numpy()) > 1e-6
    if "dynamic_rhs" in only:
        assert _rel(out["carry"]["drm"]["acc"],
                    ref["carry"]["drm"]["acc"]) <= RTOL


def test_rhs_callables_may_return_numpy():
    _, tp = _probs("cavity")
    v0 = _v0("cavity")
    tf = _torch_forcing(tp)
    kw = dict(trange=TRANGE[:8], prob=tp, inivel=v0, linsolver="dense",
              save_every=0, device="cpu")
    ref = cnab(f_tdp=tf["f_tdp"], g_tdp=tf["g_tdp"], **kw)
    out = cnab(f_tdp=lambda t: tf["f_tdp"](t).numpy().reshape(-1, 1),
               g_tdp=lambda t: tf["g_tdp"](t).numpy(), **kw)
    assert torch.equal(out["v"], ref["v"]) and torch.equal(out["p"], ref["p"])


def _first_half(scheme, name, kw):
    """The port's run over the first half of ``TRANGE`` on the inner
    layout (shared by the resume tests and the JAX-carry tests: a wake run
    without forcing is the same call)."""
    key = ("first", scheme, name)
    if key not in _CACHE:
        fn = dict(cnab=cnab, sbdf2=sbdf2)[scheme]
        _CACHE[key] = fn(trange=TRANGE[:11], inivel=_v0(name), **kw)
    return _CACHE[key]


@pytest.mark.parametrize("scheme", ["cnab", "sbdf2"])
@pytest.mark.parametrize("name", ["cavity", "wake0"])
def test_resume_carry_continues_exactly(scheme, name):
    _, tp = _probs(name)
    v0 = _v0(name)
    fn = dict(cnab=cnab, sbdf2=sbdf2)[scheme]
    kw = dict(prob=tp, linsolver="dense", save_every=3, device="cpu",
              state_layout="inner")
    if name == "cavity":
        tf = _torch_forcing(tp)
        kw.update(f_tdp=tf["f_tdp"], dynamic_rhs=tf["dynamic_rhs"],
                  dynamic_rhs_memory=tf["dynamic_rhs_memory"])
    # the unsplit run, saving every state
    every = fn(trange=TRANGE, inivel=v0, **dict(kw, save_every=1))
    first = _first_half(scheme, name, kw)
    # the carry may be stored as numpy (a checkpoint) in between
    stored = {k: (v.numpy() if torch.is_tensor(v) else v)
              for k, v in first["carry"].items()}
    second = fn(trange=TRANGE[10:], inivel=None, resume_carry=stored,
                ops=first["ops"], **kw)
    assert second["bootstrap"] is None
    for k in ("v", "p"):
        assert _rel(second[k], every[k].numpy()) <= 1e-13, k
    assert len(second["times"]) == 10 // 3
    both = torch.cat([first["vs"], second["vs"]])
    assert both.shape[0] == 9 // 3 + 10 // 3
    # saved states of the second half are states of the unsplit run
    assert _rel(second["vs"][0], every["vs"][10 + 3 - 2].numpy()) <= 1e-13


@pytest.mark.parametrize("scheme", ["cnab", "sbdf2"])
def test_a_jax_carry_resumes_in_the_port(scheme):
    jp, tp = _probs("wake0")
    v0 = _v0("wake0")
    jfn = getattr(jax_ti, scheme)
    tfn = dict(cnab=cnab, sbdf2=sbdf2)[scheme]
    kw = dict(linsolver="dense", save_every=5, state_layout="inner")
    jfirst = jfn(trange=TRANGE[:11], prob=jp, inivel=v0, **kw)
    jsecond = jfn(trange=TRANGE[10:], prob=jp, inivel=v0,
                  resume_carry=jfirst["carry"], **kw)
    carry = carry_from_jax(
        jax.tree_util.tree_map(np.asarray, jfirst["carry"]), device="cpu")
    assert "cvals" not in carry and carry["flag"].dtype == torch.bool
    assert carry["v"].dtype == torch.float64
    out = tfn(trange=TRANGE[10:], prob=tp, inivel=None, resume_carry=carry,
              device="cpu", **kw)
    _same(out, jsecond)
    # and the port's own first half leads to the same end (its save rows
    # apart, the call of the resume test)
    tfirst = _first_half(scheme, "wake0", dict(
        prob=tp, linsolver="dense", save_every=3, device="cpu",
        state_layout="inner"))
    for k in ("v", "p", "gp", "fv", "nfc" if scheme == "cnab" else "dv"):
        assert _rel(tfirst["carry"][k], carry[k].numpy()) <= RTOL, k
    assert not carry["dfv"].any() and not tfirst["carry"]["dfv"].any()


@pytest.mark.parametrize("layout", ["auto", "inner"])
def test_outfunc_is_evaluated_every_step(layout):
    jp, tp = _probs("cavity")
    v0 = _v0("cavity")
    kw = dict(trange=TRANGE[:12], inivel=v0, linsolver="dense",
              save_every=4, state_layout=layout)
    ref = jax_ti.cnab(
        prob=jp, out_bundle=dict(s=jnp.asarray(2.0)),
        outfunc=lambda b, cn, co: b["ob"]["s"] * jnp.stack(
            [jnp.linalg.norm(cn["v"]), jnp.linalg.norm(cn["v"] - co["v"])]),
        **kw)
    out = cnab(
        prob=tp, device="cpu", out_bundle=dict(s=torch.tensor(2.0)),
        outfunc=lambda b, cn, co: b["ob"]["s"] * torch.stack(
            [torch.linalg.vector_norm(cn["v"]),
             torch.linalg.vector_norm(cn["v"] - co["v"])]), **kw)
    assert out["outs"].shape == (10, 2)           # len(trange) - 2
    assert _rel(out["outs"], ref["outs"]) <= RTOL
    assert np.array_equal(out["out_times"], ref["out_times"])
    nv = tp.nv_full if layout == "auto" else len(tp.invinds)
    assert out["carry"]["v"].shape == (nv,)
    # without the hook there is nothing
    assert cnab(prob=tp, device="cpu", **kw)["outs"] is None


def test_sbdf2_refuses_the_in_loop_hook():
    """The observables hook belongs to cnab: sbdf2 must say so and not
    drop it silently."""
    _, tp = _probs("cavity")
    with pytest.raises(NotImplementedError, match="outfunc"):
        sbdf2(trange=TRANGE, prob=tp, inivel=_v0("cavity"),
              linsolver="dense", device="cpu",
              outfunc=lambda b, cn, co: cn["v"].sum())
