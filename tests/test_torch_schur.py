"""The banded block-Schur solver and the w-space CNAB step of the port vs
the JAX package on the CPU: the solver's layout (orders, windows, blocks),
``solve`` / ``solve_warm`` / ``solve_warm_wspace`` with and without the
truncated inverse W, the bf16 level storage, and the integrators on
``linsolver="schur"`` (CNAB in w-space with both ``warm_refine``, the
in-loop hook, ``sbdf2``, ``semi_implicit_euler``)."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from dolfin_navier_scipy_tpu.models import (
    cylinderwake_problem as jax_wake, drivencavity_problem as jax_cavity)
from dolfin_navier_scipy_tpu.models.functionals import (
    make_inscan_liftdrag as jax_inscan)
from dolfin_navier_scipy_tpu.solve import solve_nse as jax_solve_nse
from dolfin_navier_scipy_tpu.solve.sadpnt import (
    SchurSaddleSolver as JaxSchur, host_saddle_factorized)
from dolfin_navier_scipy_tpu.solve.timeint import _build_ops as jax_build_ops
from dolfin_navier_scipy_tpu.solve.timeint import cnab as jax_cnab
from dolfin_navier_scipy_tpu_torch.models import (
    cylinderwake_problem as torch_wake, drivencavity_problem as torch_cavity,
    make_inscan_liftdrag)
from dolfin_navier_scipy_tpu_torch.solve import (
    SchurSaddleSolver, cnab, semi_implicit_euler, solve_nse)
from dolfin_navier_scipy_tpu_torch.solve.timeint import _build_ops

from torch_parity import align_native

torch.set_num_threads(1)
# f64 work, the same algorithm: round-off apart
RTOL = 1e-10
# an f32-built W (localized PCG in both packages, summed in another
# order) under f64 work
RTOL_W = 1e-6
DT = 0.01
KW = dict(t0=0.0, tE=20 * DT, Nts=20, start_ssstokes=True,
          linsolver="schur", save_every=5)
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


def _rel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _ops(winv):
    """The CNAB full-layout Schur bundles of both packages on wake level 0
    (``winv=None``: the size gate, no W at this size)."""
    key = ("ops", winv)
    if key not in _CACHE:
        jp, tp = _probs("wake0")
        ref = jax_build_ops(jp, DT, theta=0.5, linsolver="schur",
                            layout="full", winv=winv)
        out = _build_ops(tp, DT, theta=0.5, linsolver="schur",
                         layout="full", winv=winv, device="cpu")
        _CACHE[key] = (ref, out)
    return _CACHE[key]


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


@pytest.mark.parametrize("winv", [None, True])
def test_solver_layout_equals_jax(winv):
    ref_ops, ops = _ops(winv)
    ref, slv = ref_ops.solver, ops.solver
    assert isinstance(slv, SchurSaddleSolver)
    for k in ("nv", "np", "ncg", "_bs", "_nblk", "_nin", "_bsp", "_nblkp",
              "_wj", "_jbases", "_ncolpad_j", "_wjt", "_jtbases",
              "_ncolpad_jt", "_wx", "_xbases", "_ncolpad_x", "_ww",
              "_wbases", "_ncolpad_w", "ncg_warm", "warm_size"):
        assert getattr(slv, k) == getattr(ref, k), k
    assert (slv._ww > 0) == (winv is True)
    for k in ("permf", "pidx"):
        assert np.array_equal(_np(getattr(slv, k)), np.asarray(getattr(ref,
                                                                       k)))
    # the banded operators and X are the same f32 numbers
    for k in ("Bblk", "Eblk", "Jb", "JTb", "Xb"):
        got = getattr(slv, k)
        assert got.dtype == torch.float32, k
        assert np.array_equal(got.numpy(), np.asarray(getattr(ref, k))), k
    assert np.array_equal(slv.Sinv[0, 0].numpy(), np.asarray(ref.Sinv))
    assert np.array_equal(slv.dinv_b.numpy(), np.asarray(ref.dinv_b))
    if winv:
        # both builds run the same f32 block PCG, summed in another order
        Wj = np.asarray(ref.Wb)
        assert slv.Wb.shape == Wj.shape
        assert np.abs(slv.Wb.numpy() - Wj).max() <= 1e-6 * np.abs(Wj).max()


def _rhs(slv, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(slv.nv), rng.standard_normal(slv.np)


@pytest.mark.parametrize("winv", [None, True])
@pytest.mark.parametrize("refine", [0, 1])
def test_solves_match_jax(winv, refine):
    ref_ops, ops = _ops(winv)
    ref, slv = ref_ops.solver, ops.solver
    tol = RTOL_W if winv else RTOL
    bv, bp = _rhs(slv, 1)
    ref.refine = slv.refine = refine
    try:
        got = slv.solve(torch.from_numpy(bv), torch.from_numpy(bp))
        assert _rel(got, ref.solve(jnp.asarray(bv), jnp.asarray(bp))) <= tol
    finally:
        ref.refine = slv.refine = 0
    y0 = np.random.default_rng(2).standard_normal(slv.warm_size)
    got, y = slv.solve_warm(torch.from_numpy(bv), torch.from_numpy(bp),
                            torch.from_numpy(y0), niter=6, refine=refine)
    rsol, ry = ref.solve_warm(jnp.asarray(bv), jnp.asarray(bp),
                              jnp.asarray(y0), niter=6, refine=refine)
    assert _rel(got, rsol) <= tol and _rel(y, ry) <= tol
    # w-space: the first nin entries of the rhs are the permuted inner rhs
    rw = np.random.default_rng(3).standard_normal(slv.nv)
    bpp = np.random.default_rng(4).standard_normal(slv.np)
    got = slv.solve_warm_wspace(torch.from_numpy(rw), torch.from_numpy(bpp),
                                torch.from_numpy(y0), niter=6, refine=refine)
    rgot = ref.solve_warm_wspace(jnp.asarray(rw), jnp.asarray(bpp),
                                 jnp.asarray(y0), niter=6, refine=refine)
    for a, b in zip(got, rgot):
        assert _rel(a, b) <= tol


def test_the_solve_is_the_saddle_solution():
    """On the cavity: the solver against the host LU of the saddle.  In
    f64 work the banded F, J and X are still f32 numbers (as in the JAX
    package), so a solve is exact to ~1e-7; W's truncation at its default
    3e-3 is absorbed by one refine round."""
    _, tp = _probs("cavity")
    F = sps.csr_matrix(tp.Mc + 0.5 * 1e-3 * tp.Ac)
    rng = np.random.default_rng(0)
    bv, bp = rng.standard_normal(F.shape[0]), rng.standard_normal(tp.np_cond)
    exact = host_saddle_factorized(F, tp.Jc, tp.JTc)(bv, bp).ravel()
    for winv, bars in ((False, ((0, 1e-6), (1, 1e-6))),
                       (True, ((0, 5e-3), (1, 5e-6)))):
        slv = SchurSaddleSolver(F, tp.Jc, tp.JTc, dtype=torch.float64,
                                winv=winv, device="cpu")
        assert (slv.Wb is not None) == winv
        for refine, tol in bars:
            slv.refine = refine
            got = slv.solve(torch.from_numpy(bv), torch.from_numpy(bp))
            assert _rel(got, exact) <= tol, (winv, refine)


def test_lowbit_storage_matches_jax(monkeypatch):
    """bf16 level storage (the card's default, forced here in f32 work):
    W 3, X 2 and S^-1 3 levels whose residual levels are not folded away;
    X's levels equal the JAX package's bitwise; S^-1 is the inverse of
    ``J X`` for the X as stored (the JAX package inverts ``J X`` of the
    exact X), so ``J X S^-1`` is the identity to f32 grade; the solves
    agree with the JAX package's under DNS_TPU_LOWBIT=1 within 1e-5."""
    jp, tp = _probs("cavity")
    F = sps.csr_matrix(tp.Mc + 0.5 * 1e-3 * tp.Ac)
    monkeypatch.setenv("DNS_TPU_LOWBIT", "1")
    ref = JaxSchur(coeff=F, jmat=jp.Jc, jmatT=jp.JTc, winv=True)
    slv = SchurSaddleSolver(F, tp.Jc, tp.JTc, winv=True, lowbit=True,
                            device="cpu")
    assert slv.dtype == torch.float32
    bs, npp = slv._bs, slv.np
    for name, levels in (("Wb", 3), ("Xb", 2), ("Sinv", 3)):
        st = getattr(slv, name)
        assert st.dtype == torch.bfloat16 and st.shape[1] == levels, name
        lev = st.float()
        for p in range(1, levels):
            assert float(lev[:, p].abs().max()) > 1e-4 * float(
                lev[:, p - 1].abs().max()) * 2.0 ** -8, (name, p)
    xr = np.asarray(ref.Xb.astype(jnp.float32))
    assert np.array_equal(slv.Xb.float().reshape(xr.shape).numpy(), xr)
    assert slv.Wb.shape[1] * bs == ref.Wb.shape[1]
    # J X_stored S^-1 g = g: to f32 grade in the port, to the 16 bits of
    # the stored X in the JAX package
    g = np.random.default_rng(4).standard_normal(npp)
    Jp = sps.csr_matrix(tp.Jc)[slv.pidx.numpy()][:, slv.permf.numpy()]
    xs = slv._xapply(slv._sapply(torch.from_numpy(g).float())).double()
    own = np.abs(Jp @ xs.numpy() - g).max() / np.abs(g).max()
    xj = np.asarray(ref._xapply(ref._sapply(jnp.asarray(g, jnp.float32))),
                    np.float64)
    jax_own = np.abs(Jp @ xj - g).max() / np.abs(g).max()
    assert own <= 1e-5 and own < jax_own, (own, jax_own)
    bv, bp = _rhs(slv, 5)
    exact = host_saddle_factorized(F, tp.Jc, tp.JTc)(bv, bp).ravel()
    for refine, tol in ((0, 5e-3), (1, 2e-6)):
        ref.refine = slv.refine = refine
        got = slv.solve(torch.from_numpy(bv).float(),
                        torch.from_numpy(bp).float())
        want = ref.solve(jnp.asarray(bv, jnp.float32),
                         jnp.asarray(bp, jnp.float32))
        assert _rel(got, want) <= 1e-5, refine
        assert _rel(got.double(), exact) <= tol, refine


@pytest.mark.parametrize("kw,match", [
    (dict(banded=False), "non-banded"),
])
def test_unported_schur_paths_raise(kw, match):
    # the non-banded (element-operator) path, once unported, now builds
    # and solves: its f64 solve equals the host sparse saddle solve
    _, tp = _probs("cavity")
    F = sps.csr_matrix(tp.Mc + 0.5 * 1e-3 * tp.Ac)
    slv = SchurSaddleSolver(F, tp.Jc, tp.JTc, device="cpu",
                            dtype=torch.float64, **kw)
    assert not slv.banded, match
    bv, bp = _rhs(slv, 7)
    exact = host_saddle_factorized(F, tp.Jc, tp.JTc)(bv, bp).ravel()
    got = slv.solve(torch.from_numpy(bv), torch.from_numpy(bp), refine=1)
    assert _rel(got, exact) <= 1e-10


def _jax_cnab(winv, warm_refine, layout="auto"):
    key = ("cnab", winv, warm_refine, layout)
    if key not in _CACHE:
        _CACHE[key] = jax_solve_nse(prob=_probs("wake0")[0],
                                    warm_refine=warm_refine, winv=winv,
                                    state_layout=layout, **KW)
    return _CACHE[key]


@pytest.mark.parametrize("winv", [None, True])
@pytest.mark.parametrize("warm_refine", [0, 1])
def test_cnab_wspace_matches_jax(winv, warm_refine):
    _, tp = _probs("wake0")
    ref = _jax_cnab(winv, warm_refine)
    out = solve_nse(prob=tp, device="cpu", warm_refine=warm_refine,
                    winv=winv, **KW)
    tol = RTOL_W if winv else RTOL
    for k in ("v", "p", "vs", "ps"):
        assert _rel(out[k], ref[k]) <= tol, k
    assert out["ffflag"] is False
    assert np.array_equal(out["times"], ref["times"])
    slv = out["ops"].solver
    assert isinstance(slv, SchurSaddleSolver) and hasattr(out["ops"],
                                                          "full_schur")
    assert (slv.Wb is not None) == bool(winv)
    # the carry stays in w-space: full dofs, the solver's warm start
    c = out["carry"]
    assert c["v"].shape == (tp.nv_full,)
    assert c["ysol"].shape == (slv.warm_size,) == c["ysol_p"].shape
    assert _rel(c["v"], ref["carry"]["v"]) <= tol


def test_cnab_schur_inner_layout_matches_jax():
    _, tp = _probs("wake0")
    ref = _jax_cnab(None, 0, layout="inner")
    out = solve_nse(prob=tp, device="cpu", state_layout="inner", **KW)
    assert out["carry"]["v"].shape == (len(tp.invinds),)
    for k in ("v", "p", "vs", "ps"):
        assert _rel(out[k], ref[k]) <= RTOL, k


def test_cnab_wspace_hook_sees_natural_order():
    jp, tp = _probs("wake0")
    ops = _ops(None)[1]
    base = _jax_cnab(None, 0)
    trange = np.linspace(0.0, 20 * DT, 21)
    kw = dict(trange=trange, inivel=base["iniv"], save_every=0)
    seen = []

    def grab(b, cnew, cold):
        seen.append((cnew["v"].clone(), cnew["p"].clone()))
        return cnew["p"][:3]

    out = cnab(prob=tp, ops=ops, device="cpu", outfunc=grab, **kw)
    v_last, p_last = seen[-1]
    assert torch.equal(v_last[torch.as_tensor(tp.invinds)], out["v"])
    assert torch.equal(p_last, out["p"])
    assert torch.equal(out["outs"][-1], out["p"][:3])
    # the lift/drag series of both packages on the Schur step
    tf, tob = make_inscan_liftdrag(tp, DT, charvel=0.2)
    jf, job = jax_inscan(jp, DT, charvel=0.2)
    got = cnab(prob=tp, ops=ops, device="cpu", outfunc=tf, out_bundle=tob,
               **kw)
    ref = jax_cnab(prob=jp, ops=_ops(None)[0], outfunc=jf, out_bundle=job,
                   **kw)
    outs, routs = got["outs"].numpy(), np.asarray(ref["outs"])
    scale = np.abs(routs).max(axis=0)
    # f32 dots of ~1e3 terms, summed in another order
    assert (np.abs(outs - routs).max(axis=0) <= 1e-5 * scale).all()
    assert torch.equal(got["v"], out["v"])


def test_sbdf2_schur_matches_jax():
    jp, tp = _probs("wake0")
    kw = dict(KW, time_int_scheme="sbdf2")
    ref = jax_solve_nse(prob=jp, **kw)
    out = solve_nse(prob=tp, device="cpu", **kw)
    assert isinstance(out["ops"].solver, SchurSaddleSolver)
    for k in ("v", "p", "vs", "ps"):
        assert _rel(out[k], ref[k]) <= RTOL, k


def test_semi_implicit_euler_on_the_schur_solver():
    """The JAX package's ``semi_implicit_euler`` takes the dense solver at
    this size; the port's on ``linsolver='schur'`` reaches the dense
    trajectory to the f32 storage of the banded operators (~1e-7)."""
    _, tp = _probs("cavity")
    v0 = np.random.default_rng(6).standard_normal(len(tp.invinds)) * 1e-2
    trange = np.linspace(0.0, 10 * DT, 11)
    dense = semi_implicit_euler(trange=trange, prob=tp, inivel=v0,
                                linsolver="dense", device="cpu")
    schur = semi_implicit_euler(trange=trange, prob=tp, inivel=v0,
                                linsolver="schur", device="cpu")
    assert isinstance(schur["ops"].solver, SchurSaddleSolver)
    assert _rel(schur["v"], dense["v"].numpy()) <= 1e-6
    assert _rel(schur["p"], dense["p"].numpy()) <= 1e-6
