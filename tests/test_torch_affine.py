"""The affine element matvecs (``ops.kernels.affine_mv``: the CUDA kernel of
``csrc/affine.cu`` on the card, its plain version here) vs the JAX
package's ``AffineVectorOps`` on the CPU in f64, on a Robin-penalized wake
(facet rows from the outflow and the two control arcs) in both dof
layouts; the wrapper's checks.  The problems without Robin rows are
``tests/test_torch_convection.py::test_affine_matvecs``'s."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dolfin_navier_scipy_tpu.control import apply_robin_penalty as jax_robin
from dolfin_navier_scipy_tpu.models import cylinderwake_problem as jax_wake
from dolfin_navier_scipy_tpu.ops.affine import AffineVectorOps as JaxAffine
from dolfin_navier_scipy_tpu_torch.control import apply_robin_penalty
from dolfin_navier_scipy_tpu_torch.models import (
    cylinderwake_problem as torch_wake)
from dolfin_navier_scipy_tpu_torch.ops.affine import AffineVectorOps
from dolfin_navier_scipy_tpu_torch.ops.kernels import affine_mv, affine_mv_ref

from torch_parity import align_native

torch.set_num_threads(1)
RTOL = 1e-12
_CACHE = {}


def _pair(full_dofs):
    if full_dofs not in _CACHE:
        if "probs" not in _CACHE:
            align_native()
            kw = dict(level=0, Re=100, charvel=0.2, bccontrol=True)
            jp, tp = jax_wake(**kw), torch_wake(device="cpu", **kw)
            jax_robin(jp, palpha=1e-3)
            apply_robin_penalty(tp, palpha=1e-3)
            _CACHE["probs"] = (jp, tp)
        jp, tp = _CACHE["probs"]
        _CACHE[full_dofs] = (
            JaxAffine.build(jp, jnp.float64, full_dofs=full_dofs),
            AffineVectorOps.build(tp, torch.float64, full_dofs=full_dofs,
                                  device="cpu"))
    return _CACHE[full_dofs]


def _rel(a, b):
    a, b = a.numpy(), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("full_dofs", [False, True])
@pytest.mark.parametrize("mode", ["m", "a", "ma", "j", "jt"])
def test_affine_with_robin_rows_matches_jax(mode, full_dofs):
    jaff, taff = _pair(full_dofs)
    # the outflow blocks and the Robin arcs' boundary-mass blocks
    assert taff.fac_elem.shape[0] == jaff.fac_elem.shape[0] > 0
    rng = np.random.default_rng(17)
    x = rng.normal(size=taff.nin)
    q = rng.normal(size=taff.npc)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if mode == "m":
        ref, out = jaff.m_matvec(jx), taff.m_matvec(tx)
    elif mode == "a":
        ref, out = jaff.a_matvec(jx), taff.a_matvec(tx)
    elif mode == "ma":
        ref = jaff.ma_matvec(jx, 1.0, 0.005)
        out = taff.view("ma", cm=1.0, ca=0.005).matvec(tx)
    elif mode == "j":
        ref, out = jaff.j_matvec(jx), taff.view("j").matvec(tx)
    else:
        ref = jaff.jt_matvec(jnp.asarray(q))
        out = taff.view("j").rmatvec(torch.from_numpy(q))
    assert _rel(out, ref) <= RTOL
    if not full_dofs:
        tp = _CACHE["probs"][1]
        mats = dict(m=tp.Mc @ x, a=tp.Ac @ x,
                    ma=tp.Mc @ x + 0.005 * (tp.Ac @ x), j=tp.Jc @ x,
                    jt=tp.JTc @ q)
        assert _rel(out, mats[mode]) <= 1e-11


def test_affine_mv_wrapper_checks():
    _, taff = _pair(False)
    x = torch.zeros(taff.nin, dtype=torch.float64)
    with pytest.raises(ValueError, match="mode"):
        affine_mv("mt", x, taff)
    with pytest.raises(ValueError, match="1-D tensor"):
        affine_mv("jt", x, taff)               # J^T takes pressures
    with pytest.raises(ValueError, match="1-D tensor"):
        affine_mv("m", x[:-1], taff)
    # on the CPU the wrapper is the plain version and counts no launch
    n0 = affine_mv.launches
    y = torch.from_numpy(np.random.default_rng(3).normal(size=taff.nin))
    assert torch.equal(affine_mv("ma", y, taff, 2.0, 0.1),
                       affine_mv_ref("ma", y, taff, 2.0, 0.1))
    assert torch.equal(affine_mv("a", y, taff),
                       affine_mv_ref("ma", y, taff, 0.0, 1.0))
    assert affine_mv.launches == n0

