"""The dense saddle-inverse solver of the port vs the JAX package's and
vs host SuperLU."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from dolfin_navier_scipy_tpu.models import (
    cylinderwake_problem as jax_wake, drivencavity_problem as jax_cavity)
from dolfin_navier_scipy_tpu.solve.sadpnt import (
    InverseSaddleSolver as JaxInverseSaddleSolver)
from dolfin_navier_scipy_tpu_torch.models import (
    cylinderwake_problem as torch_wake, drivencavity_problem as torch_cavity)
from dolfin_navier_scipy_tpu_torch.ops.kernels import vecmat
from dolfin_navier_scipy_tpu_torch.solve.sadpnt import (
    InverseSaddleSolver, _to_dense, host_saddle_factorized,
    solve_sadpnt_host)
from dolfin_navier_scipy_tpu_torch.utils.convert import (
    inverse_solver_from_numpy)

from torch_parity import align_native

torch.set_num_threads(1)
DT = 0.01
_CACHE = {}


def _setup(name):
    if name not in _CACHE:
        align_native()
        if name == "cavity":
            jp = jax_cavity(N=6, Re=100)
            tp = torch_cavity(N=6, Re=100, device="cpu")
        else:
            jp = jax_wake(level=0, Re=100)
            tp = torch_wake(level=0, Re=100, device="cpu")
        coeff = sps.csr_matrix(tp.Mc + 0.5 * DT * tp.Ac)
        rng = np.random.default_rng(20)
        rhsv = rng.normal(size=coeff.shape[0])
        rhsp = rng.normal(size=tp.np_cond)
        host = solve_sadpnt_host(amat=coeff, jmat=tp.Jc, jmatT=tp.JTc,
                                 rhsv=rhsv, rhsp=rhsp).ravel()
        jsol = JaxInverseSaddleSolver(
            sps.csr_matrix(jp.Mc + 0.5 * DT * jp.Ac), jp.Jc, jp.JTc)
        _CACHE[name] = dict(jp=jp, tp=tp, coeff=coeff, rhsv=rhsv, rhsp=rhsp,
                            host=host, jsol=jsol)
    return _CACHE[name]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("name", ["cavity", "wake0"])
def test_inverse_solver_matches_jax_and_host(name):
    s = _setup(name)
    tp = s["tp"]
    sol = InverseSaddleSolver(s["coeff"], tp.Jc, tp.JTc, device="cpu")
    assert sol.KinvT.dtype == torch.float64 and sol.refine == 0
    assert sol.KinvT.is_contiguous()
    x = sol.solve(torch.from_numpy(s["rhsv"]), torch.from_numpy(s["rhsp"]))
    xj = s["jsol"].solve(jnp.asarray(s["rhsv"]), jnp.asarray(s["rhsp"]))
    assert _rel(x.numpy(), xj) <= 1e-10
    assert _rel(x.numpy(), s["host"]) <= 1e-10
    # both packages hold the same inverse, the port transposed
    assert _rel(sol.Kinv.numpy(), s["jsol"].Kinv) <= 1e-9


@pytest.mark.parametrize("name", ["cavity", "wake0"])
def test_solver_built_from_the_jax_inverse(name):
    s = _setup(name)
    tp = s["tp"]
    sol = inverse_solver_from_numpy(np.asarray(s["jsol"].Kinv), s["coeff"],
                                    tp.Jc, tp.JTc, device="cpu")
    assert torch.equal(sol.Kinv, torch.from_numpy(np.array(s["jsol"].Kinv)))
    x = sol.solve(torch.from_numpy(s["rhsv"]), torch.from_numpy(s["rhsp"]))
    xj = s["jsol"].solve(jnp.asarray(s["rhsv"]), jnp.asarray(s["rhsp"]))
    # identical inverse, only the summation order of one matvec differs
    assert _rel(x.numpy(), xj) <= 1e-12


@pytest.mark.parametrize("res", ["sparse", "element"])
def test_refinement_recovers_f64_from_an_f32_inverse(res):
    s = _setup("cavity")
    tp = s["tp"]
    res_ops = None
    if res == "element":
        aff = tp.affine_ops(torch.float64, device="cpu")
        res_ops = (aff.view("ma", cm=1.0, ca=0.5 * DT), aff.view("j"))
    rv, rp = torch.from_numpy(s["rhsv"]), torch.from_numpy(s["rhsp"])
    errs = []
    for refine in (0, 3):
        sol = InverseSaddleSolver(s["coeff"], tp.Jc, tp.JTc, device="cpu",
                                  inv_dtype=torch.float32, refine=refine,
                                  res_ops=res_ops)
        assert sol.KinvT.dtype == torch.float32
        errs.append(_rel(sol.solve(rv, rp).numpy(), s["host"]))
    # an f32 inverse alone is f32-accurate; three f64 residual rounds
    # contract the error by its f32 rounding each
    assert 1e-9 < errs[0] < 1e-4
    assert errs[1] <= 1e-10


def test_default_refine_follows_the_inverse_dtype():
    s = _setup("cavity")
    tp = s["tp"]
    sol = InverseSaddleSolver(s["coeff"], tp.Jc, tp.JTc, device="cpu",
                              inv_dtype=torch.float32)
    assert sol.refine == 3
    with pytest.raises(ValueError, match="inv_method"):
        InverseSaddleSolver(s["coeff"], tp.Jc, tp.JTc, device="cpu",
                            inv_method="newton-schulz")
    # on the CPU "device" is torch.linalg.inv in f64 on that device
    sd = InverseSaddleSolver(s["coeff"], tp.Jc, tp.JTc, device="cpu",
                             inv_method="device")
    sh = InverseSaddleSolver(s["coeff"], tp.Jc, tp.JTc, device="cpu",
                             inv_method="host")
    assert _rel(sd.KinvT.numpy(), sh.KinvT.numpy()) <= 1e-9


def test_apply_inv_goes_through_vecmat(monkeypatch):
    s = _setup("cavity")
    tp = s["tp"]
    sol = InverseSaddleSolver(s["coeff"], tp.Jc, tp.JTc, device="cpu",
                              inv_dtype=torch.float32, refine=2)
    calls = []
    import dolfin_navier_scipy_tpu_torch.solve.sadpnt as mod

    def spy(x, KT):
        calls.append((x.dtype, KT.data_ptr()))
        return vecmat(x, KT)

    monkeypatch.setattr(mod, "vecmat", spy)
    sol.solve(torch.from_numpy(s["rhsv"]), torch.from_numpy(s["rhsp"]))
    # one apply for x0 and one per refinement round, all on the stored
    # transposed inverse, in its dtype
    assert calls == [(torch.float32, sol.KinvT.data_ptr())] * 3


def test_host_helpers():
    s = _setup("cavity")
    tp = s["tp"]
    K = np.block([[_to_dense(s["coeff"]), _to_dense(tp.JTc)],
                  [_to_dense(tp.Jc), np.zeros((tp.np_cond,) * 2)]])
    rhs = np.concatenate([s["rhsv"], s["rhsp"]])
    assert np.abs(K @ s["host"] - rhs).max() <= 1e-9
    x0 = host_saddle_factorized(s["coeff"], tp.Jc)(s["rhsv"])
    assert x0.shape == (len(rhs), 1)
    with pytest.raises(NotImplementedError, match="Woodbury"):
        solve_sadpnt_host(amat=s["coeff"], jmat=tp.Jc, rhsv=s["rhsv"],
                          umat=np.zeros((3, 1)), vmat=np.zeros((1, 3)))
