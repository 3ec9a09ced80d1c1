"""The slice as a whole: ``solve_nse`` of the port vs the JAX package on
the CPU in f64 (20 CNAB steps, both state layouts), and its dispatch to
Newton-in-time."""

import os

import numpy as np
import pytest
import torch

from dolfin_navier_scipy_tpu.models import (
    cylinderwake_problem as jax_wake, drivencavity_problem as jax_cavity)
from dolfin_navier_scipy_tpu.solve import get_pfromv as jax_get_pfromv
from dolfin_navier_scipy_tpu.solve import solve_nse as jax_solve_nse
from dolfin_navier_scipy_tpu_torch.models import (
    cylinderwake_problem as torch_wake, drivencavity_problem as torch_cavity)
from dolfin_navier_scipy_tpu_torch.ops.kernels import vecmat
from dolfin_navier_scipy_tpu_torch.solve import (
    cnab, get_pfromv, solve_nse, solve_nse_newton_ti, solve_steadystate_nse)
from dolfin_navier_scipy_tpu_torch.solve.timeint import (
    _build_ops, build_full_layout)
from dolfin_navier_scipy_tpu_torch.utils.convert import (
    problem_from_numpy, problem_to_numpy)

from torch_parity import align_native

torch.set_num_threads(1)
RTOL = 1e-10
KW = dict(t0=0.0, tE=0.2, Nts=20, start_ssstokes=True,
          time_int_scheme="cnab", linsolver="dense", save_every=5)
_CACHE = {}


def _probs(name):
    if name not in _CACHE:
        align_native()
        if name == "cavity":
            _CACHE[name] = (jax_cavity(N=8, Re=100),
                            torch_cavity(N=8, Re=100))
        else:
            _CACHE[name] = (jax_wake(level=0, Re=100, charvel=0.2),
                            torch_wake(level=0, Re=100, charvel=0.2))
    return _CACHE[name]


def _jax_run(name, layout):
    key = ("jaxrun", name, layout)
    if key not in _CACHE:
        _CACHE[key] = jax_solve_nse(prob=_probs(name)[0],
                                    state_layout=layout, **KW)
    return _CACHE[key]


def _port_run(name, layout):
    """The port's run of the same call (shared by the tests that read
    it)."""
    key = ("portrun", name, layout)
    if key not in _CACHE:
        _CACHE[key] = solve_nse(prob=_probs(name)[1], state_layout=layout,
                                device="cpu", **KW)
    return _CACHE[key]


def _rel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _assert_same_run(out, ref):
    for k in ("v", "p", "vs", "ps", "iniv", "inip"):
        assert _rel(out[k], ref[k]) <= RTOL, k
    assert out["ffflag"] is False and ref["ffflag"] is False
    assert np.array_equal(out["times"], ref["times"])
    assert np.array_equal(out["out_times"], ref["out_times"])
    assert out["vs"].shape[0] == 19 // 5
    assert set(out) >= {"v", "p", "ffflag", "times", "vs", "ps", "outs",
                        "out_times", "bootstrap", "ops", "carry"}
    assert set(out["carry"]) >= {"v", "p", "nfc", "gp", "flag"}


@pytest.mark.parametrize("name", ["cavity", "wake0"])
@pytest.mark.parametrize("layout", ["auto", "inner"])
def test_solve_nse_matches_jax(name, layout):
    ref = _jax_run(name, layout)
    out = _port_run(name, layout)
    _assert_same_run(out, ref)
    assert out["v"].dtype == torch.float64 and out["v"].device.type == "cpu"
    # the full layout carries all velocity dofs, the inner one only its own
    nv = (_probs(name)[1].nv_full if layout == "auto"
          else len(_probs(name)[1].invinds))
    assert out["carry"]["v"].shape == (nv,)


@pytest.mark.parametrize("name", ["cavity", "wake0"])
def test_solve_nse_on_a_problem_carried_across(name):
    jp = _probs(name)[0]
    tp = problem_from_numpy(problem_to_numpy(jp), device="cpu")
    out = solve_nse(prob=tp, device="cpu", **KW)
    _assert_same_run(out, _jax_run(name, "auto"))


def test_trange_iniv_inip_and_vp_dict():
    jp, tp = _probs("cavity")
    ref = _jax_run("cavity", "auto")
    trange = np.linspace(0.0, 0.2, 21)
    v_full = np.zeros(tp.nv_full)
    v_full[tp.bcinds] = tp.bcvals
    v_full[tp.invinds] = ref["iniv"]
    # full-length iniv is cut to the inner dofs; the pressure then comes
    # from get_pfromv
    out = solve_nse(prob=tp, trange=trange, iniv=v_full, linsolver="dense",
                    save_every=5, return_vp_dict=True, device="cpu")
    # the JAX package's run of this call: the shared run's trajectory (the
    # same trange and initial velocity; a plain run does not read inip,
    # so the same bits) and get_pfromv's initial pressure
    refj = dict(v=ref["v"], p=ref["p"],
                inip=np.asarray(jax_get_pfromv(v=ref["iniv"],
                                               prob=jp)).ravel())
    for k in ("v", "p", "inip"):
        assert _rel(out[k], refj[k]) <= RTOL, k
    assert sorted(out["vp_dict"]) == [float(t) for t in out["times"]]
    first = out["vp_dict"][float(out["times"][0])]
    assert np.array_equal(first["v"], out["vs"][0].numpy())
    out2 = solve_nse(prob=tp, trange=trange, iniv=ref["iniv"],
                     inip=ref["inip"], linsolver="dense", save_every=0,
                     device="cpu")
    assert out2["vs"] is None and out2["times"] is None
    assert _rel(out2["v"], ref["v"]) <= RTOL


def test_stokes_flow_takes_the_inner_step():
    jp, tp = _probs("cavity")
    kw = dict(KW, stokes_flow=True)
    out = solve_nse(prob=tp, device="cpu", **kw)
    ref = jax_solve_nse(prob=jp, **kw)
    assert out["carry"]["v"].shape == (len(tp.invinds),)
    for k in ("v", "p", "inip"):
        assert _rel(out[k], ref[k]) <= RTOL, k


def test_fast_precision_keeps_an_f64_carry_within_1e6():
    """f32 element kernels and an f32-stored inverse under the f64 carry —
    the arithmetic the card runs — stay within 1e-6 of the f64 run."""
    _, tp = _probs("wake0")
    acc = _port_run("wake0", "auto")
    for layout in ("auto", "inner"):
        fast = solve_nse(prob=tp, device="cpu", precision="fast",
                         state_layout=layout, **KW)
        assert fast["ops"].wdtype == torch.float32
        assert fast["ops"].solver.KinvT.dtype == torch.float32
        assert fast["v"].dtype == torch.float64
        assert _rel(fast["v"], acc["v"].numpy()) <= 1e-6


def test_full_layout_pads_the_transposed_inverse(monkeypatch):
    _, tp = _probs("cavity")
    dt = 0.01
    ops = _build_ops(tp, dt, theta=0.5, linsolver="dense", device="cpu")
    fl = build_full_layout(tp, dt, ops)
    nf, npp = tp.nv_full, tp.np_cond
    ZpT = fl["ZpT"]
    assert ZpT.shape == (nf + npp, nf + npp) and ZpT.stride(1) == 1
    assert ZpT.stride(0) * ZpT.element_size() % 16 == 0
    ix = np.concatenate([tp.invinds, nf + np.arange(npp)])
    assert torch.equal(ZpT[ix][:, ix], ops.solver.KinvT)
    bc = np.setdiff1d(np.arange(nf), tp.invinds)
    assert ZpT[bc].abs().max() == 0 and ZpT[:, bc].abs().max() == 0
    assert build_full_layout(tp, dt, ops) is fl          # cached

    # every step of the full-layout loop applies ZpT through vecmat: once
    import dolfin_navier_scipy_tpu_torch.solve.timeint as mod
    seen = []

    def spy(x, KT):
        seen.append(tuple(KT.shape))
        return vecmat(x, KT)

    monkeypatch.setattr(mod, "vecmat", spy)
    cnab(trange=np.linspace(0, 10 * dt, 11), prob=tp,
         inivel=np.zeros(len(tp.invinds)), ops=ops, device="cpu",
         save_every=0)
    assert seen == [(nf + npp, nf + npp)] * 9             # len(trange) - 2


def test_blowup_freezes_the_state_and_sets_the_flag():
    _, tp = _probs("cavity")
    out = solve_nse(prob=tp, device="cpu", check_ff_maxv=1e-3, **KW)
    assert out["ffflag"] is True
    assert bool(out["carry"]["flag"])
    # frozen at the bootstrap state from the first loop step on
    assert torch.equal(out["v"], out["bootstrap"]["v"])
    assert torch.equal(out["vs"][0], out["vs"][-1])


def test_stokes_start_matches_the_host_solve():
    jp, tp = _probs("cavity")
    v, p = solve_steadystate_nse(tp, only_stokes=True, return_vp=True,
                                 linsolver="host-sparse")
    assert v.shape == (tp.nv_full, 1) and p.shape == (tp.np_cond, 1)
    assert np.abs(tp.Jc @ v[tp.invinds, 0] - tp.fp.ravel()).max() <= 1e-12
    assert np.array_equal(v[tp.bcinds, 0], tp.bcvals)
    v_only = solve_steadystate_nse(tp, only_stokes=True,
                                   linsolver="host-sparse")
    assert np.array_equal(v_only, v)


@pytest.mark.parametrize("kwargs,match", [
    (dict(save_data=True), "save_data"),
    (dict(checkpoint_every=5), "checkpoint_every"),
    (dict(paraviewoutput=True), "paraviewoutput"),
    (dict(useolddata=True), "useolddata"),
])
def test_unported_paths_raise(kwargs, match, tmp_path):
    """The checkpoint and output keywords, which raised until they were
    ported, are taken: each run ends where the plain run ends (to the
    rounding of the sections' steps) and writes what it names."""
    _, tp = _probs("cavity")
    if "plain" not in _CACHE:
        _CACHE["plain"] = solve_nse(prob=tp, device="cpu",
                                    **dict(KW, state_layout="inner"))
    files = dict(data_prfx=str(tmp_path / "d" / "traj"),
                 vfileprfx=str(tmp_path / "v" / "vel"))
    out = solve_nse(prob=tp, device="cpu", **dict(KW, **kwargs, **files))
    ref = _CACHE["plain"]
    assert (out["v"] - ref["v"]).abs().max() <= 1e-13 * ref["v"].abs().max()
    written = sorted(os.listdir(tmp_path)) if os.path.isdir(tmp_path) else []
    want = dict(save_data=["d"], paraviewoutput=["v"])
    assert written == want.get(match, []), (match, written)
    if match == "save_data":
        assert len(os.listdir(tmp_path / "d")) == 4      # Nts // 4 apart
    if match == "paraviewoutput":
        assert out["pvdfile"] == files["vfileprfx"] + ".pvd"


def test_auto_linsolver_raises_above_the_dense_window():
    """'auto' takes the banded block-Schur solver above 6000 condensed rows
    (it raised there until that solver was ported); 'krylov' is taken when
    named; the steady solver's velocity cache (which raised until it was
    ported) finds no stored state in an empty store and solves."""
    from types import SimpleNamespace

    from dolfin_navier_scipy_tpu_torch.solve.timeint import _resolve_linsolver

    small = SimpleNamespace(invinds=np.arange(5000), np_cond=1000)
    big = SimpleNamespace(invinds=np.arange(5001), np_cond=1000)
    assert _resolve_linsolver(small, "auto") == "dense"
    assert _resolve_linsolver(big, "auto") == "schur"
    assert _resolve_linsolver(small, "schur") == "schur"
    assert _resolve_linsolver(big, "krylov") == "krylov"
    with pytest.raises(ValueError):
        _resolve_linsolver(small, "lu")
    with pytest.raises(ValueError, match="time_int_scheme"):
        solve_nse(prob=_probs("cavity")[1], device="cpu",
                  **dict(KW, time_int_scheme="rk4"))
    v = solve_steadystate_nse(_probs("cavity")[1], useolddata=True,
                              data_prfx="no/such/store/", verbose=False,
                              linsolver="host-sparse", only_stokes=True)
    assert v.shape == (_probs("cavity")[1].nv_full, 1)


def _tiny():
    """A 4x4 cavity, its Stokes start and a short horizon: the Newton-in-time
    dispatch is checked against the direct call (the twins of the JAX
    package's tests run in ``test_torch_newton_ti.py``)."""
    if "tiny" not in _CACHE:
        tp = torch_cavity(N=4, Re=50, device="cpu")
        v = solve_steadystate_nse(tp, only_stokes=True,
                                  linsolver="host-sparse")
        _CACHE["tiny"] = (tp, v.ravel()[tp.invinds],
                          np.linspace(0.0, 0.03, 4))
    return _CACHE["tiny"]


def _newton_direct(**kw):
    tp, v0, trange = _tiny()
    return solve_nse_newton_ti(prob=tp, trange=trange, iniv=v0,
                               vel_nwtn_stps=1, vel_pcrd_stps=1,
                               device="cpu", **kw)


def _newton_ref():
    """The direct call the dispatch cases equal: each linearizes about the
    initial state (a ``lin_vel_point`` equal to it, full length or not),
    with ``get_pfromv``'s pressure."""
    if "newton_ref" not in _CACHE:
        tp, v0, _ = _tiny()
        _CACHE["newton_ref"] = _newton_direct(inip=np.asarray(
            get_pfromv(v=v0, prob=tp, device="cpu")).ravel())
    return _CACHE["newton_ref"]


@pytest.mark.parametrize("how", ["treat_nonl_explicit", "lin_vel_point",
                                 "lin_vel_point_full"])
def test_newton_in_time_is_dispatched(how):
    """``treat_nonl_explicit=False`` or a ``lin_vel_point`` takes
    Newton-in-time (formerly ``NotImplementedError``), with the facade's
    own Picard default and the initial pressure from ``get_pfromv``."""
    tp, v0, trange = _tiny()
    kw = dict(treat_nonl_explicit=False)
    lvp = None
    if how != "treat_nonl_explicit":
        lvp = v0 if how == "lin_vel_point" else tp.embed(
            torch.from_numpy(v0)).numpy()
        kw = dict(lin_vel_point=lvp)
    out = solve_nse(prob=tp, trange=trange, iniv=v0, vel_nwtn_stps=1,
                    vel_pcrd_stps=1, save_every=1, device="cpu", **kw)
    ref = _newton_ref()
    assert torch.equal(out["v_traj"], ref["v_traj"])
    assert torch.equal(out["ps"], ref["ps"])
    assert out["nwtn_norms"] == ref["nwtn_norms"]
    assert out["stats"]["sweeps"] == len(out["nwtn_norms"]) == 2


def test_newton_in_time_static_feedback_reaches_the_system():
    """``closed_loop`` static feedback hands ``umat``, ``vmat`` and the
    throughput ``b (b^T w)`` to Newton-in-time."""
    tp, v0, trange = _tiny()
    nin = len(v0)
    rng = np.random.default_rng(3)
    B, mtxtb = 1e-2 * rng.normal(size=(nin, 2)), rng.normal(size=(nin, 2))
    w = np.linspace(0.0, 1.0, nin)
    out = solve_nse(prob=tp, trange=trange, iniv=v0, vel_nwtn_stps=1,
                    vel_pcrd_stps=1, treat_nonl_explicit=False,
                    closed_loop=True, static_feedback=True, b_mat=B,
                    feedbackthroughdict={None: dict(mtxtb=mtxtb, w=w)},
                    device="cpu")
    ref = _newton_direct(umat=B, vmat=mtxtb.T, fv_extra=B @ (B.T @ w),
                         inip=out["ps"][0].numpy())
    assert torch.equal(out["v_traj"], ref["v_traj"])
