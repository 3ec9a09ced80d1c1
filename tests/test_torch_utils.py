"""The port's utilities and its checkpoint and output paths (``utils/io.py``,
``utils/vtk.py``, ``utils/spectra.py``, ``solve_nse``'s ``save_data`` /
``useolddata`` / ``clearprvdata`` / ``checkpoint_every`` /
``return_dictofvelstrs`` / ``paraviewoutput``, ``solve_steadystate_nse``'s
velocity cache) against the JAX package on the CPU: twins of
``tests/test_io.py`` and of ``test_parity_misc.py``'s steady caching and
DAE spectra, file names equal to the JAX package's, checkpoints resumed
exactly and across the packages, PVD series equal when parsed."""

import glob
import json
import os
import re

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from dolfin_navier_scipy_tpu.models import (
    drivencavity_problem as jax_cavity)
from dolfin_navier_scipy_tpu.solve import solve_nse as jax_solve_nse
from dolfin_navier_scipy_tpu.utils import io as jax_io
from dolfin_navier_scipy_tpu.utils.spectra import (
    leading_evals as jax_leading_evals)
from dolfin_navier_scipy_tpu.utils.vtk import PVDWriter as JaxPVDWriter
from dolfin_navier_scipy_tpu_torch.models import (
    drivencavity_problem as torch_cavity)
from dolfin_navier_scipy_tpu_torch.solve import (
    solve_nse, solve_steadystate_nse, steady)
from dolfin_navier_scipy_tpu_torch.utils import io as dou
from dolfin_navier_scipy_tpu_torch.utils.spectra import leading_evals
from dolfin_navier_scipy_tpu_torch.utils.vtk import PVDWriter

from torch_parity import align_native

torch.set_num_threads(1)
RTOL = 1e-10


def _rel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return np.abs(a - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


# -- utils/io.py: the twins of tests/test_io.py ---------------------------------

def test_npa_roundtrip(tmp_path):
    v = np.random.default_rng(0).random((17, 1))
    f = str(tmp_path / "vec")
    dou.save_npa(torch.as_tensor(v), f)
    assert np.array_equal(dou.load_npa(f), v)
    assert np.array_equal(dou.load_npa(f + ".npy"), v)


def test_spa_roundtrip(tmp_path):
    m = sps.random(8, 9, density=0.3, format="csr", random_state=1)
    f = str(tmp_path / "mat")
    dou.save_spa(m, f)
    assert abs(dou.load_spa(f) - m).max() < 1e-15


def test_load_or_comp(tmp_path):
    calls = []

    def comp():
        calls.append(1)
        return np.arange(5.0)

    f = str(tmp_path / "memo")
    a = dou.load_or_comp(filestr=f, comprtn=comp, verbose=False)
    b = dou.load_or_comp(filestr=f, comprtn=comp, verbose=False)
    assert np.array_equal(a, b) and len(calls) == 1


def test_output_json_and_measure(tmp_path):
    f = str(tmp_path / "sig.json")
    tmesh = [0.0, 0.5, 1.0]
    sig = [[0.0], [1.0], [2.0]]
    dou.save_output_json(dict(tmesh=tmesh, outsig=sig), fstring=f)
    with open(f) as fh:
        d = json.load(fh)
    assert d["datadict"]["outsig"] == sig
    err = dou.meas_output_diff(sig, tmesh, lambda t: np.array([2 * t]))
    assert err == jax_io.meas_output_diff(sig, tmesh,
                                          lambda t: np.array([2 * t]))
    dou.save_outp_sig_tikz(tmesh, sig, str(tmp_path / "sig.tex"))
    assert open(tmp_path / "sig.tex").read().count("addplot") == 1


@pytest.mark.parametrize("kw", [
    dict(time=1.0, meshp=2, nu=1e-3, Nts=10, semiexpl=True),
    dict(time=1.0, meshp=2, nu=None, Nts=10),
    dict(time=None, meshp=None, nu=None, Nts=None, data_prfx="a/b"),
    dict(time=0.0123456789, meshp=8, nu=0.01, Nts=None, data_prfx="p_")])
def test_timer_and_datastr(kw):
    info = {}
    with dou.Timer("t1", timerinfo=info, verbose=False, device="cpu"):
        sum(range(1000))
    assert info["t1"] > 0
    assert dou.get_datastr(**kw) == jax_io.get_datastr(**kw)
    if kw.get("semiexpl"):
        # the reference's format (get_datastr_snu)
        assert dou.get_datastr(**kw) == \
            "time1.00000e+00_nu1.000e-03_mesh2_Nts10_semexp"


def test_timer_trace_annotation(tmp_path):
    """``trace_dir``: a torch.profiler trace of the region, with the
    region's ``annotate`` range in it."""
    td = str(tmp_path / "trace")
    with dou.Timer("traced-op", trace_dir=td, annotate=True,
                   verbose=False) as tm:
        torch.ones((64, 64)).sum()
    assert os.path.isfile(tm.trace_file)
    names = {e.get("name") for e in json.load(open(tm.trace_file))[
        "traceEvents"]}
    assert "traced-op" in names


# -- the PVD series, written by both packages -----------------------------------

_NUM = re.compile(r"^-?\d+(\.\d*)?([eE][-+]?\d+)?$")


def _parsed(path):
    """A VTU / PVD file as ``(words, numbers)``: its text with every number
    replaced by a mark, and the numbers."""
    words, nums = [], []
    for w in re.split(r"(\s+|\"|<|>)", open(path).read()):
        if _NUM.match(w):
            words.append("#")
            nums.append(float(w))
        else:
            words.append(w)
    return words, np.asarray(nums)


def _same_series(a, b):
    """Two PVD series (prefixes): the same files, structure and values
    (1e-12 of the largest)."""
    fa = sorted(os.path.basename(f) for f in glob.glob(a + "*"))
    fb = sorted(os.path.basename(f) for f in glob.glob(b + "*"))
    pa, pb = os.path.basename(a), os.path.basename(b)
    assert [f.replace(pa, "") for f in fa] == [f.replace(pb, "") for f in fb]
    for f, g in zip(fa, fb):
        wa, na = _parsed(os.path.join(os.path.dirname(a), f))
        wb, nb = _parsed(os.path.join(os.path.dirname(b), g))
        assert [w.replace(pa, "") for w in wa] == \
            [w.replace(pb, "") for w in wb]
        assert na.shape == nb.shape
        assert np.abs(na - nb).max() <= 1e-12 * max(1.0, np.abs(nb).max())
    return len(fa)


def test_pvd_writer(tmp_path):
    align_native()
    jp = jax_cavity(N=4, nu=1e-2)
    tp = torch_cavity(N=4, nu=1e-2, device="cpu")
    rng = np.random.default_rng(2)
    jw = JaxPVDWriter(str(tmp_path / "jax" / "flow"), jp)
    tw = PVDWriter(str(tmp_path / "torch" / "flow"), tp)
    for t in (0.0, 0.5):
        v, p = rng.random(tp.nv_full), rng.random(tp.np_cond)
        jw.write(v_full=v, p=p, t=t)
        tw.write(v_full=torch.as_tensor(v), p=torch.as_tensor(p), t=t)
    jw.close()
    tw.close()
    assert "DataSet" in open(tmp_path / "torch" / "flow.pvd").read()
    assert _same_series(str(tmp_path / "torch" / "flow"),
                        str(tmp_path / "jax" / "flow")) == 3


# -- the steady velocity cache and the DAE spectra ------------------------------

def test_steady_caching(tmp_path, monkeypatch):
    """The second call loads the stored state: no route is built."""
    prob = torch_cavity(N=6, nu=1e-2, device="cpu")
    prfx = str(tmp_path / "cav")
    v1 = solve_steadystate_nse(prob, verbose=False, vel_nwtn_tol=1e-11,
                               save_data=True, data_prfx=prfx)

    def poisoned(*a, **k):
        raise AssertionError("the cached state was not loaded")

    monkeypatch.setattr(steady, "_dense_route", poisoned)
    v2 = solve_steadystate_nse(prob, verbose=False, vel_nwtn_tol=1e-11,
                               useolddata=True, data_prfx=prfx)
    assert np.array_equal(v1, v2)
    (v3, p3), norms = solve_steadystate_nse(
        prob, verbose=False, vel_nwtn_tol=1e-11, useolddata=True,
        data_prfx=prfx, return_vp=True, return_nwtnupd_norms=True)
    assert np.array_equal(v3, v1) and p3.shape == (prob.np_cond, 1)
    assert norms[0] < 1e-11
    # a stricter tolerance than the stored norm, or a cleared store: solve
    with pytest.raises(AssertionError, match="not loaded"):
        solve_steadystate_nse(prob, verbose=False, vel_nwtn_tol=1e-30,
                              useolddata=True, data_prfx=prfx)
    with pytest.raises(AssertionError, match="not loaded"):
        solve_steadystate_nse(prob, verbose=False, vel_nwtn_tol=1e-11,
                              useolddata=True, clearprvdata=True,
                              data_prfx=prfx)


def test_dae_pencil_spectra():
    align_native()
    jp = jax_cavity(N=5, nu=1e-1)
    tp = torch_cavity(N=5, nu=1e-1, device="cpu")
    vss = solve_steadystate_nse(tp, verbose=False, vel_nwtn_tol=1e-11)
    ev = leading_evals(tp, torch.as_tensor(vss.ravel()), k=6, sigma=0.1)
    ref = jax_leading_evals(jp, jnp.asarray(vss.ravel()), k=6, sigma=0.1)
    order = np.lexsort
    ev = ev[order((ev.imag, ev.real))]
    ref = ref[order((ref.imag, ref.real))]
    assert np.abs(ev - ref).max() <= 1e-8 * np.abs(ref).max()
    # the lid-driven cavity at Re=10 is linearly stable
    assert np.all(ev.real < 0)


# -- solve_nse's checkpoints, trajectory files and PVD series -------------------

NTS, CK = 8, 3          # checkpoints after steps 3, 6 and 8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One checkpointed run of each package on a 6x6 cavity (with the
    trajectory files and the PVD series), and the port's run of the same
    horizon in one piece."""
    align_native()
    root = tmp_path_factory.mktemp("ckpt")
    jp = jax_cavity(N=6, nu=1e-2)
    tp = torch_cavity(N=6, nu=1e-2, device="cpu")
    v0 = np.asarray(solve_steadystate_nse(
        tp, only_stokes=True, linsolver="host-sparse",
        verbose=False)).ravel()[tp.invinds]
    kw = dict(t0=0.0, tE=0.08, Nts=NTS, iniv=v0, save_every=2)

    def files(pkg):
        return dict(data_prfx=str(root / pkg / "data" / "traj"),
                    vfileprfx=str(root / pkg / "vtk" / "vel"))

    ckpt = dict(save_data=True, checkpoint_every=CK, paraviewoutput=True,
                return_dictofvelstrs=True)
    jout = jax_solve_nse(prob=jp, **kw, **ckpt, **files("jax"))
    tout = solve_nse(prob=tp, **kw, **ckpt, **files("torch"),
                     device="cpu")
    whole = solve_nse(prob=tp, **dict(kw, save_every=1),
                      state_layout="inner", device="cpu")
    return dict(jp=jp, tp=tp, kw=kw, files=files, jout=jout, tout=tout,
                whole=whole)


def _carries(prfx):
    return sorted(os.path.basename(f)
                  for f in glob.glob(prfx + "*__carry.npz"))


def test_checkpoint_files_and_series_equal_jax(runs):
    r = runs
    jf, tf = r["files"]("jax"), r["files"]("torch")
    names = _carries(tf["data_prfx"])
    assert len(names) == 3 and names == _carries(jf["data_prfx"])
    for t in (0.03, 0.06, 0.08):
        assert os.path.basename(jax_io.get_datastr(
            time=t, meshp=r["tp"].nv_full, nu=r["tp"].nu, Nts=NTS,
            data_prfx=tf["data_prfx"], semiexpl=True)) + "__carry.npz" \
            in names
    assert _rel(r["tout"]["v"], r["jout"]["v"]) <= RTOL
    jd, td = r["jout"]["dictofvelstrs"], r["tout"]["dictofvelstrs"]
    # the saved states of the sections (save_every counts in each)
    assert sorted(jd) == sorted(td) and len(td) == 3
    for t in td:
        assert os.path.basename(td[t]) == os.path.basename(jd[t])
        assert _rel(np.load(td[t]), np.load(jd[t])) <= RTOL
    assert r["tout"]["pvdfile"] == tf["vfileprfx"] + ".pvd"
    assert _same_series(tf["vfileprfx"], jf["vfileprfx"]) == len(td) + 1


def test_sections_and_resume_equal_the_uninterrupted_run(runs):
    """A run resumed from the last checkpoint but one gives the bits of the
    uninterrupted checkpointed run; that run is the run in one piece but
    for the rounding of each section's step (its ``trange`` difference)."""
    r = runs
    whole, tout = r["whole"], r["tout"]
    for k in ("v", "p"):
        assert _rel(tout[k], whole[k].numpy()) <= 1e-13, k
    for i, t in enumerate(tout["times"]):
        j = int(np.abs(whole["times"] - t).argmin())
        assert _rel(tout["vs"][i], whole["vs"][j].numpy()) <= 1e-13
    whole = tout
    tf = r["files"]("torch")
    final = glob.glob(tf["data_prfx"] + "time8.00000e-02*__carry.npz")
    assert len(final) == 1
    os.remove(final[0])
    out = solve_nse(prob=r["tp"], **r["kw"], useolddata=True,
                    checkpoint_every=CK, device="cpu", **tf)
    assert torch.equal(out["v"], whole["v"])
    assert torch.equal(out["p"], whole["p"])
    # a store holding the final step answers without a step
    out = solve_nse(prob=r["tp"], **r["kw"], save_data=True,
                    useolddata=True, checkpoint_every=CK, device="cpu",
                    **tf)
    again = solve_nse(prob=r["tp"], **r["kw"], useolddata=True,
                      checkpoint_every=CK, device="cpu", **tf)
    assert again["resumed_from"] == pytest.approx(0.08)
    assert torch.equal(again["v"], whole["v"])


def test_checkpoints_resume_across_the_packages(runs):
    """A JAX checkpoint resumed in the port, and a port checkpoint resumed
    in the JAX package, end where the writer's own run ends."""
    r = runs
    jf, tf = r["files"]("jax"), r["files"]("torch")
    for prfx in (jf["data_prfx"], tf["data_prfx"]):
        for f in glob.glob(prfx + "time8.00000e-02*__carry.npz"):
            os.remove(f)
    out = solve_nse(prob=r["tp"], **r["kw"], useolddata=True,
                    checkpoint_every=CK, device="cpu",
                    data_prfx=jf["data_prfx"])
    assert _rel(out["v"], r["jout"]["v"]) <= RTOL
    jout = jax_solve_nse(prob=r["jp"], **r["kw"], useolddata=True,
                         checkpoint_every=CK, data_prfx=tf["data_prfx"])
    assert _rel(np.asarray(jout["v"]), r["tout"]["v"]) <= RTOL
    # clearprvdata empties the store (and writes nothing without
    # save_data)
    assert _carries(tf["data_prfx"])
    solve_nse(prob=r["tp"], **r["kw"], clearprvdata=True, device="cpu",
              data_prfx=tf["data_prfx"])
    assert _carries(tf["data_prfx"]) == []
