"""The block-Schur factors built on the device (``setup="device"``) in the
port vs the JAX package on the CPU: the block PCG, the fold of solved X
columns into the band, S formed from the stored X, the whole device setup
against the JAX package's device setup and the port's host setup, and a
w-space CNAB run whose operator bundle holds a device-setup solver."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

import dolfin_navier_scipy_tpu.solve.sadpnt as jsp
import dolfin_navier_scipy_tpu_torch.solve.sadpnt as tsp
import dolfin_navier_scipy_tpu_torch.solve.timeint as tti
from dolfin_navier_scipy_tpu.models import (
    cylinderwake_problem as jax_wake, drivencavity_problem as jax_cavity)
from dolfin_navier_scipy_tpu.ops.sparse import ell_from_scipy_fast
from dolfin_navier_scipy_tpu.solve.timeint import _build_ops as jax_build_ops
from dolfin_navier_scipy_tpu.solve.timeint import cnab as jax_cnab
from dolfin_navier_scipy_tpu_torch.models import (
    cylinderwake_problem as torch_wake, drivencavity_problem as torch_cavity)
from dolfin_navier_scipy_tpu_torch.ops.kernels import band_operand
from dolfin_navier_scipy_tpu_torch.solve import SchurSaddleSolver, cnab
from dolfin_navier_scipy_tpu_torch.solve.steady import solve_steadystate_nse

from torch_parity import align_native

torch.set_num_threads(1)
DT = 1e-3
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


def _coeff(tp):
    return sps.csr_matrix(tp.Mc + 0.5 * DT * tp.Ac)


def _solvers(name):
    """The JAX package's device setup, the port's device and host setups
    (f32 work and storage, no W at these sizes), on ``F = M + dt/2 A``."""
    key = ("solvers", name)
    if key not in _CACHE:
        jp, tp = _probs(name)
        F = _coeff(tp)
        _CACHE[key] = (
            jsp.SchurSaddleSolver(coeff=F, jmat=jp.Jc, jmatT=jp.JTc,
                                  setup="device"),
            SchurSaddleSolver(F, tp.Jc, tp.JTc, setup="device",
                              device="cpu"),
            SchurSaddleSolver(F, tp.Jc, tp.JTc, setup="host", device="cpu"))
    return _CACHE[key]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_block_pcg_matches_jax():
    """The block PCG against ``_block_pcg_jit`` in f64 on the cavity's F
    (the port's operator a dense product, the JAX package's its ELL
    gather); an all-zero column stays exactly zero."""
    _, tp = _probs("cavity")
    F = _coeff(tp)
    n = F.shape[0]
    B = np.random.default_rng(0).standard_normal((n, 5))
    B[:, 3] = 0.0
    dinv = 1.0 / F.diagonal()
    ell = ell_from_scipy_fast(F, dtype=jnp.float64)
    want = np.asarray(jsp._block_pcg_jit(ell.cols, ell.vals,
                                         jnp.asarray(dinv), jnp.asarray(B),
                                         30))
    Fd = torch.from_numpy(F.toarray())
    got = tsp._block_pcg(lambda P: Fd @ P, torch.from_numpy(dinv),
                         torch.from_numpy(B), 30).numpy()
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    assert not got[:, 3].any()
    # 30 iterations reach the solution of the SPD system
    assert _rel(got, np.linalg.solve(F.toarray(), B)) <= 1e-8


def test_banded_operator_is_f():
    """The block-tridiagonal ``torch.bmm`` product the device setup solves
    with is ``F_perm`` on a block of columns."""
    _, tp = _probs("wake0")
    F = _coeff(tp)
    blocks, perm, bs, nblk = tsp._build_banded(F)
    n = F.shape[0]
    P = np.zeros((nblk * bs, 3))
    P[:n] = np.random.default_rng(1).standard_normal((n, 3))
    got = tsp._tridiag_bmm(torch.from_numpy(blocks).double(),
                           torch.from_numpy(P)).numpy()
    Fp = F[perm][:, perm].astype(np.float32).astype(np.float64)
    assert np.abs(got[:n] - Fp @ P[:n]).max() <= 1e-12 * np.abs(got).max()
    assert not got[n:].any()


@pytest.mark.parametrize("start,sizes", [(0, (7, 40, 33)), (13, (50,))])
def test_xt_parts_to_banded_matches_numpy(start, sizes):
    """The fold of ``X^T`` row-parts into the banded window layout, in
    f64, against a numpy fold and against the JAX package's fold (f32)."""
    nblk, bs, wx, nin, npp = 4, 16, 24, 58, start + sum(sizes)
    rng = np.random.default_rng(2)
    XT = rng.standard_normal((npp, nin))
    bases = tuple(int(b) for b in np.linspace(0, npp - wx, nblk))
    parts, lo = [], start
    for m in sizes:
        parts.append(torch.from_numpy(XT[lo: lo + m]))
        lo += m
    got = tsp._xt_parts_to_banded(
        parts, bases, bs, nblk, wx, nin, start=start,
        out=band_operand((nblk, bs, wx), torch.float64, "cpu")).numpy()
    want = np.zeros((nblk, bs, wx))
    for kb, b in enumerate(bases):
        for i in range(bs):
            r = kb * bs + i
            for j in range(wx):
                if r < nin and start <= b + j < npp:
                    want[kb, i, j] = XT[b + j, r]
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    jx = np.asarray(jsp._xt_parts_to_banded(
        [jnp.asarray(p.numpy()) for p in parts], bases, bs, nblk, wx, nin,
        start=start))
    assert np.array_equal(
        np.asarray(got, np.float32)[:, :, : jx.shape[2]], jx)


@pytest.mark.parametrize("levels", [1, 2])
def test_schur_of_banded_matches_numpy(levels):
    """S = J X from the stored banded X (f32 blocks or two bf16 levels
    summed) and the f32 ``J^T`` blocks, against the dense numpy product
    of the same numbers in f64."""
    _, slv, _ = _solvers("wake0")
    Xb = slv.Xb if levels == 1 else tsp.pair_stack(slv.Xb, parts=2)
    S = tsp._schur_of_banded(slv.JTb, slv._jtbases, Xb, slv._xbases,
                             slv.np).numpy()
    xs = Xb.double() if levels == 1 else Xb.double().sum(1)
    nin, npp, bs = slv._nin, slv.np, slv._bs
    Xd = np.zeros((nin, max(npp, slv._ncolpad_x)))
    for kb, b in enumerate(slv._xbases):
        rows = min(bs, nin - kb * bs)
        Xd[kb * bs: kb * bs + rows, b: b + slv._wx] = xs[kb, :rows].numpy()
    _, tp = _probs("wake0")
    Jp = sps.csr_matrix(tp.Jc)[slv.pidx.numpy()][:, slv.permf.numpy()]
    Jp = Jp.astype(np.float32).astype(np.float64)
    want = Jp @ Xd[:, :npp]
    assert S.shape == (npp, npp)
    assert np.abs(S - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("name", ["cavity", "wake0"])
def test_device_setup_matches_jax_and_host(name):
    """X to the f32 floor of the host's (splu) and the JAX package's
    (block PCG) X; the same windows; solves within 1e-5 of the host
    setup's.  Against the JAX package's device setup the refined solves
    agree within 1e-5; unrefined, its S^-1 (f32 LU + Newton-Schulz) leaves
    ~1.3e-5 of the exact saddle solution where the port's f64 inverse
    leaves ~2e-6, so there the port must be the nearer of the two."""
    jp, tp = _probs(name)
    ref, dev, host = _solvers(name)
    for k in ("ncg", "_bs", "_nblk", "_wx", "_xbases", "_wjt", "_jtbases",
              "_ww"):
        assert getattr(dev, k) == getattr(host, k) == getattr(ref, k), k
    assert set(dev.setup_timing) == {"probes_s", "banded_s", "x_s", "s_s",
                                     "sinv_s", "w_s"}
    xd, xh, xj = dev.Xb.numpy(), host.Xb.numpy(), np.asarray(ref.Xb)
    scale = np.abs(xh).max()
    assert xd.dtype == np.float32 and xd.shape == xh.shape == xj.shape
    assert np.abs(xd - xh).max() <= 1e-5 * scale
    assert np.abs(xd - xj).max() <= 1e-5 * scale
    rng = np.random.default_rng(3)
    bv, bp = rng.standard_normal(dev.nv), rng.standard_normal(dev.np)
    exact = jsp.host_saddle_factorized(_coeff(tp), tp.Jc, tp.JTc)(
        bv, bp).ravel()
    tbv, tbp = (torch.from_numpy(b).float() for b in (bv, bp))
    try:
        for refine in (0, 1):
            ref.refine = dev.refine = host.refine = refine
            got = dev.solve(tbv, tbp).double().numpy()
            assert _rel(got, host.solve(tbv, tbp).double().numpy()) <= 1e-5
            want = np.asarray(ref.solve(jnp.asarray(bv, jnp.float32),
                                        jnp.asarray(bp, jnp.float32)))
            if refine:
                assert _rel(got, want) <= 1e-5
            else:
                assert _rel(got, exact) <= min(1e-5, _rel(want, exact))
    finally:
        ref.refine = dev.refine = host.refine = 0


def test_device_setup_is_reproducible_and_lowbit():
    """Two device builds give the same bits (the fold copies, nothing
    accumulates); with the card's bf16 storage forced, the factors have
    their 2/3 levels and J X S^-1 is the identity to f32 grade."""
    _, tp = _probs("cavity")
    F = _coeff(tp)
    a, b = (SchurSaddleSolver(F, tp.Jc, tp.JTc, setup="device", winv=True,
                              lowbit=True, device="cpu") for _ in range(2))
    for k in ("Xb", "Sinv", "Wb"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k, levels in (("Wb", 3), ("Xb", 2), ("Sinv", 3)):
        st = getattr(a, k)
        assert st.dtype == torch.bfloat16 and st.shape[1] == levels, k
    g = np.random.default_rng(4).standard_normal(a.np)
    Jp = sps.csr_matrix(tp.Jc)[a.pidx.numpy()][:, a.permf.numpy()]
    xs = a._xapply(a._sapply(torch.from_numpy(g).float())).double()
    assert np.abs(Jp @ xs.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def _device_setup(cls):
    """``cls`` with ``setup="device"`` fixed: what ``_build_ops`` builds
    on a card at level 2, made on the CPU."""
    def make(*args, **kw):
        return cls(*args, setup="device", **kw)
    return make


@pytest.mark.parametrize("warm_refine", [0, 1])
def test_cnab_wspace_on_device_setup_matches_jax(monkeypatch, warm_refine):
    """20 w-space CNAB steps on wake level 0 whose operator bundle holds a
    device-setup solver with W (``full_map``, ``band_extra``, built by
    ``_build_ops``).  With a refine round, against the same run of the JAX
    package: within 1e-6 (measured: v 9e-11, p 2.4e-8).  Unrefined, the
    JAX package's device S^-1 (an f32 inverse) moves its pressure 6.2e-4
    from the dense solver's where its host setup stays at 2.0e-4; the
    port's f64 S^-1 keeps the host setup's run: within 1e-6 of the port's
    host-setup run, itself within 1e-7 of the JAX package's
    (``test_torch_schur.py``)."""
    jp, tp = _probs("wake0")
    v0 = solve_steadystate_nse(tp, only_stokes=True).ravel()[tp.invinds]
    trange = np.linspace(0.0, 20 * DT, 21)
    kw = dict(trange=trange, inivel=v0, save_every=0,
              warm_refine=warm_refine)
    build = dict(theta=0.5, linsolver="schur", layout="full", winv=True)
    if not warm_refine:
        host = cnab(prob=tp, device="cpu", ops=tti._build_ops(
            tp, DT, device="cpu", **build), **kw)
    monkeypatch.setattr(jsp, "SchurSaddleSolver",
                        _device_setup(jsp.SchurSaddleSolver))
    monkeypatch.setattr(tti, "SchurSaddleSolver",
                        _device_setup(tti.SchurSaddleSolver))
    ops = tti._build_ops(tp, DT, device="cpu", **build)
    slv = ops.solver
    assert slv.Wb is not None and slv.Eblk is not None
    assert slv.nv == tp.nv_full and slv.setup_timing["x_s"] > 0
    got = cnab(prob=tp, ops=ops, device="cpu", **kw)
    assert got["ffflag"] is False
    if warm_refine:
        want = jax_cnab(prob=jp, ops=jax_build_ops(jp, DT, **build), **kw)
    else:
        want = {k: host[k].numpy() for k in ("v", "p")}
    for k in ("v", "p"):
        assert _rel(got[k].numpy(), want[k]) <= 1e-6, k
