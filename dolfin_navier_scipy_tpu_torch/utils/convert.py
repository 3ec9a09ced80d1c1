"""State carried across between the JAX package and this port.

Both packages compile a mesh into the same host data (numpy arrays and
scipy matrices).  :func:`problem_to_numpy` flattens a compiled problem —
of either package, it reads attributes only — into a plain dict;
:func:`problem_from_numpy` rebuilds the port's :class:`NSEProblem` (and
with it the ``ConvectionKernel`` / ``AffineVectorOps`` tables) from such
a dict, and :func:`inverse_solver_from_numpy` wraps a ready dense inverse
into the port's :class:`InverseSaddleSolver`.  With these both packages
compute on identical operators even where the host assembly could differ
in ordering.  :func:`carry_from_jax` turns a loop carry of the JAX
integrators into the port's, so that a run started there resumes here.
"""

from types import SimpleNamespace

import numpy as np
import scipy.sparse as sps

from ..device import resolve_device
from ..models.problem import GeoSetup, NSEProblem
from ..solve.sadpnt import InverseSaddleSolver
from ..solve.timeint import _restore_carry

# the carry keys of the port's inner-layout cnab / sbdf2 loops; the JAX
# carries also hold control state (cvals cmems bfv mbc mbc_p), which is
# empty in a run without controls and has no counterpart here yet
_CARRY_KEYS = ("v", "dv", "p", "nfc", "nfc_p", "fv", "dfv", "drm", "gp",
               "flag")
_CTX_TABLES = ("N2", "dN2", "N1", "dN1", "qpts", "qwts", "JinvT", "detJ",
               "wdet", "gphi2", "gphi1")


def problem_to_numpy(prob):
    """Flatten a compiled problem into a dict of numpy/scipy data."""
    ctx, space = prob.ctx, prob.space
    d = dict(
        nu=float(prob.nu), Re=float(prob.Re),
        gradvsymmtrc=bool(getattr(prob, "gradvsymmtrc", True)),
        ppin=prob.geo.ppin,
        full={k: sps.csr_matrix(v) for k, v in prob.full.items()
              if sps.issparse(v)},
        Mc=sps.csr_matrix(prob.Mc), Ac=sps.csr_matrix(prob.Ac),
        Jc=sps.csr_matrix(prob.Jc), JTc=sps.csr_matrix(prob.JTc),
        MP=sps.csr_matrix(prob.MP),
        fv=np.asarray(prob.fv), fp=np.asarray(prob.fp),
        invinds=np.asarray(prob.invinds), bcinds=np.asarray(prob.bcinds),
        bcvals=np.asarray(prob.bcvals),
        elem_tensors={k: np.asarray(v)
                      for k, v in prob.elem_tensors.items()},
        ctx={k: np.asarray(getattr(ctx, k)) for k in _CTX_TABLES},
        dim=int(getattr(ctx, "dim", 2)),
        p2_dofmap=np.asarray(space.p2_dofmap),
        p1_dofmap=np.asarray(space.p1_dofmap),
        vdofs_of_cells=np.asarray(space.vdofs_of_cells()),
        nv_full=int(space.nv_full), np_full=int(space.np_full),
    )
    return d


def problem_from_numpy(d, device=None):
    """The port's :class:`NSEProblem` from a :func:`problem_to_numpy`
    dict.  The space and the assembly context are table holders only (no
    mesh): enough for the device kernels and the time integrators."""
    vd = np.asarray(d["vdofs_of_cells"])
    space = SimpleNamespace(
        scheme="TH", dim=d["dim"], mesh=None,
        p2_dofmap=np.asarray(d["p2_dofmap"]),
        p1_dofmap=np.asarray(d["p1_dofmap"]),
        nv_full=int(d["nv_full"]), np_full=int(d["np_full"]),
        vdofs_of_cells=lambda: vd,
    )
    ctx = SimpleNamespace(space=space, dim=d["dim"],
                          **{k: np.asarray(d["ctx"][k])
                             for k in _CTX_TABLES})
    return NSEProblem(
        space=space, ctx=ctx, geo=GeoSetup(ppin=d.get("ppin")),
        nu=d["nu"], Re=d["Re"], full=dict(d["full"]),
        Mc=d["Mc"], Ac=d["Ac"], Jc=d["Jc"], JTc=d["JTc"], MP=d["MP"],
        fv=np.asarray(d["fv"]), fp=np.asarray(d["fp"]),
        invinds=np.asarray(d["invinds"]), bcinds=np.asarray(d["bcinds"]),
        bcvals=np.asarray(d["bcvals"]),
        elem_tensors={k: np.asarray(v)
                      for k, v in d["elem_tensors"].items()},
        gradvsymmtrc=d["gradvsymmtrc"], device=device,
    )


def inverse_solver_from_numpy(Kinv, amat, jmat, jmatT=None, refine=None,
                              inv_dtype=None, dtype=None, res_ops=None,
                              device=None):
    """The port's :class:`InverseSaddleSolver` around a ready dense
    inverse ``Kinv (nv+np, nv+np)`` (e.g. the JAX solver's), skipping the
    inversion; ``amat/jmat`` are still needed for the residual operators."""
    return InverseSaddleSolver(
        amat, jmat, jmatT, refine=refine, inv_dtype=inv_dtype, dtype=dtype,
        res_ops=res_ops, device=device,
        _KinvT=np.ascontiguousarray(np.asarray(Kinv).T))


def carry_from_jax(carry, device=None):
    """The port's ``resume_carry`` from the final carry of a JAX
    inner-layout ``cnab`` or ``sbdf2`` run without controls.

    ``carry``: the JAX ``out["carry"]`` with its array leaves as numpy
    arrays (``jax.tree_util.tree_map(np.asarray, out["carry"])``; the
    port imports no jax).  Leaves keep their dtypes (f64 state, work-dtype
    convection terms, bool flag) and land on ``device`` (``None`` = the
    card); ``drm``, the memory of a ``dynamic_rhs``, may be any nesting of
    dicts, lists and tuples."""
    if carry.get("cvals") is not None:
        raise NotImplementedError(
            "carry_from_jax: the carry of a run with Dirichlet controls "
            "(controls are not ported yet)")
    return _restore_carry({k: carry[k] for k in _CARRY_KEYS if k in carry},
                          resolve_device(device))
