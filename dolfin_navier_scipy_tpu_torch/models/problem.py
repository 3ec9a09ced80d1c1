"""The compiled NSE problem: operators + index sets + device kernels.

``build_problem`` is the one-stop constructor playing the role of the
reference's ``get_sysmats`` (problem_setups.py:34-220): assemble the
Stokes family, resolve Dirichlet BCs by condensation, optionally pin the
pressure, and bundle everything with the device convection kernels.

The problem itself is host data (numpy/scipy).  Its device objects
(:class:`ConvectionKernel`, :class:`AffineVectorOps`) are built lazily,
per ``(dtype, device)``; ``prob.device`` (``None`` = the card) is the
device the attribute-style accessors use.
"""

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import scipy.sparse as sps
import torch

from ..device import resolve_device
from ..fem.dofmap import TaylorHoodSpace
from ..ops.assemble import AssemblyContext, assemble_stokes, assemble_rhs
from ..ops.condense import condense_sysmats
from ..ops.convection import ConvectionKernel


@dataclass
class GeoSetup:
    """Declarative boundary/geometry description (the JSON-descriptor
    schema of tests/mesh/*_geo_cntrlbc.json, problem_setups.py:829-962)."""

    charlen: float = 1.0
    inflow_tag: Optional[int] = None
    inflow_fn: Optional[Callable] = None      # x -> (2,)
    wall_tags: List[int] = field(default_factory=list)
    outflow_tag: Optional[int] = None
    moving_wall_tags: List[int] = field(default_factory=list)
    moving_wall_fns: Dict[int, Callable] = field(default_factory=dict)
    liftdrag_tag: Optional[int] = None
    control_tags: List[int] = field(default_factory=list)
    control_shapefuns: List[Callable] = field(default_factory=list)
    odcoo: Optional[dict] = None
    ppin: Optional[int] = None                # pressure pinning (-1 or None)
    moving_wall_cntrl: bool = False           # moving walls are controls


@dataclass
class NSEProblem:
    """Everything needed to simulate one flow configuration."""

    space: TaylorHoodSpace
    ctx: AssemblyContext
    geo: GeoSetup
    nu: float
    Re: float

    # full-dof scipy operators
    full: Dict[str, sps.spmatrix] = field(default_factory=dict)
    # condensed scipy operators
    Mc: sps.spmatrix = None
    Ac: sps.spmatrix = None
    Jc: sps.spmatrix = None
    JTc: sps.spmatrix = None
    MP: sps.spmatrix = None
    fv: np.ndarray = None            # condensed+merged rhs (nin,1)
    fp: np.ndarray = None            # (np_cond,1)
    invinds: np.ndarray = None
    bcinds: np.ndarray = None
    bcvals: np.ndarray = None
    fv_body_full: np.ndarray = None  # unmerged body force, full dofs
    fp_body_full: np.ndarray = None
    ldsbcinds: Optional[np.ndarray] = None   # lift/drag surface vdofs
    # Dirichlet-control dof groups: list of (dofs, stencil) pairs — the
    # analogue of the reference's diricontbcinds/diricontbcvals
    # (stokes_navier_utils.py:259-265)
    dircntrl: Optional[List] = None
    # Robin control operators (bccontrol=True): boundary mass and input
    # columns over the inner dofs
    Arob: Optional[sps.spmatrix] = None
    Brob: Optional[np.ndarray] = None
    elem_tensors: Optional[Dict] = None      # per-element M/A/J blocks
    gradvsymmtrc: bool = True
    device: Optional[object] = None          # None = the card

    def __post_init__(self):
        self._conv_kernels = {}
        self._affine_ops = {}
        self._element_ops = {}
        self._steady_kernels = {}

    # -- sizes ---------------------------------------------------------------
    @property
    def nv_full(self):
        return self.space.nv_full

    @property
    def np_cond(self):
        return self.Jc.shape[0]

    # -- lazy device objects ---------------------------------------------------
    def _dev(self, device=None):
        return resolve_device(self.device if device is None else device)

    def conv_kernel_on(self, dtype=None, device=None) -> ConvectionKernel:
        """The convection kernel in ``dtype`` on ``device`` (cached)."""
        dtype = dtype or torch.float64
        device = self._dev(device)
        key = (str(dtype), str(device))
        if key not in self._conv_kernels:
            self._conv_kernels[key] = ConvectionKernel(
                self.ctx, dtype=dtype, device=device)
        return self._conv_kernels[key]

    @property
    def conv_kernel(self) -> ConvectionKernel:
        return self.conv_kernel_on(torch.float64)

    @property
    def conv_kernel_f32(self) -> ConvectionKernel:
        """f32 convection kernel (the integrators' fast mode)."""
        return self.conv_kernel_on(torch.float32)

    def affine_ops(self, dtype=None, device=None):
        """Affine-factorized fused matvec bundle (the fast path)."""
        from ..ops.affine import AffineVectorOps

        if self.elem_tensors is None:
            return None
        dtype = dtype or torch.float64
        device = self._dev(device)
        key = (str(dtype), str(device))
        if key not in self._affine_ops:
            self._affine_ops[key] = AffineVectorOps.build(
                self, dtype=dtype, device=device)
        return self._affine_ops[key]

    def element_ops(self, device=None):
        """Element-level (M, A, J) operators on the inner dofs (f64, on
        ``device``; cached)."""
        if self.elem_tensors is None:
            return None
        device = self._dev(device)
        key = str(device)
        if key not in self._element_ops:
            from ..ops.elementop import build_element_ops

            self._element_ops[key] = build_element_ops(self, device=device)
        return self._element_ops[key]

    def steady_kernel(self, device=None):
        """The dense steady solver's state on ``device`` (cached)."""
        device = self._dev(device)
        key = str(device)
        if key not in self._steady_kernels:
            from ..solve.steady import SteadySolverKernel

            self._steady_kernels[key] = SteadySolverKernel(self,
                                                           device=device)
        return self._steady_kernels[key]

    # -- helpers ----------------------------------------------------------------
    def bc_full_vec(self) -> np.ndarray:
        """Full-size vector with boundary values set, zero at inner dofs."""
        out = np.zeros(self.nv_full)
        out[self.bcinds] = self.bcvals
        return out

    def embed(self, v_inner, device=None):
        """Inner vector -> full vector with boundary values appended (a
        tensor on ``v_inner``'s device, or on ``device`` for host input)."""
        if not torch.is_tensor(v_inner):
            v_inner = torch.as_tensor(
                np.asarray(v_inner, dtype=np.float64).ravel(),
                device=self._dev(device))
        full = torch.as_tensor(self.bc_full_vec()).to(
            device=v_inner.device, dtype=v_inner.dtype)
        full[torch.as_tensor(self.invinds, device=v_inner.device)] = \
            v_inner.reshape(-1)
        return full


def build_problem(
    mesh,
    geo: GeoSetup,
    nu: float = None,
    Re: float = None,
    charvel: float = 1.0,
    gradvsymmtrc: bool = True,
    bccontrol: bool = False,
    scheme: str = "TH",
    device=None,
) -> NSEProblem:
    """Compile a mesh + geometry description into an :class:`NSEProblem`.

    ``device`` is only recorded (``prob.device``): nothing is moved to a
    device before a kernel or solver asks for it."""
    dim = getattr(mesh, "dim", 2)
    if scheme != "TH" or dim != 2:
        raise NotImplementedError(
            f"scheme {scheme!r} in {dim}D: only 2D Taylor-Hood is ported so "
            "far (3D and CR follow in a later slice)")
    space = TaylorHoodSpace(mesh)
    ctx = AssemblyContext(space)

    if Re is not None:
        nu = charvel * geo.charlen / Re
    else:
        Re = charvel * geo.charlen / nu

    mats = assemble_stokes(
        ctx,
        nu=nu,
        gradvsymmtrc=gradvsymmtrc,
        outflow_tag=geo.outflow_tag,
        control_tags=geo.control_tags if bccontrol else None,
        control_shapefuns=geo.control_shapefuns if bccontrol else None,
    )

    # ---- Dirichlet data ------------------------------------------------------
    zerofn = lambda x: np.zeros(dim)          # noqa: E731
    bcdict = {}
    dircntrl = []
    for tag in geo.wall_tags:
        bcdict.update(space.dirichlet_dofs(tag, zerofn))
    for tag in geo.moving_wall_tags:
        fn = geo.moving_wall_fns.get(tag, zerofn)
        if geo.moving_wall_cntrl:
            # control dofs: excluded from the inner set, zero static value,
            # time-varying values applied by the integrators' controls
            stencil_d = space.dirichlet_dofs(tag, fn)
            cdofs = np.array(sorted(stencil_d), dtype=np.int64)
            dircntrl.append((cdofs, np.array([stencil_d[i] for i in cdofs])))
            bcdict.update({int(i): 0.0 for i in cdofs})
        else:
            bcdict.update(space.dirichlet_dofs(tag, fn))
    if not bccontrol:
        for tag in geo.control_tags:
            bcdict.update(space.dirichlet_dofs(tag, zerofn))
    if geo.inflow_tag is not None:
        bcdict.update(space.dirichlet_dofs(geo.inflow_tag, geo.inflow_fn))
    dbcinds = np.array(sorted(bcdict), dtype=np.int64)
    dbcvals = np.array([bcdict[i] for i in dbcinds])

    # ---- rhs + pressure pinning ----------------------------------------------
    fv_full, fp_full = assemble_rhs(ctx)    # zero body force by default
    mats_c = dict(mats)   # pinning applies to the condensed system only;
    fp_cond = fp_full     # prob.full keeps the untouched operators
    if geo.ppin is not None:
        if geo.ppin != -1:
            raise NotImplementedError("can only pin p at the last dof")
        mats_c["J"] = sps.csr_matrix(mats["J"])[:-1, :]
        mats_c["JT"] = sps.csr_matrix(mats["JT"])[:, :-1]
        fp_cond = fp_full[:-1]

    matsc, rhsbc, invinds, bcinds, bcvals = condense_sysmats(
        mats_c, [dbcinds], [dbcvals]
    )

    prob = NSEProblem(
        space=space,
        ctx=ctx,
        geo=geo,
        nu=nu,
        Re=Re,
        full=mats,
        Mc=matsc["M"],
        Ac=matsc["A"],
        Jc=matsc["J"],
        JTc=matsc["JT"],
        MP=matsc["MP"],
        fv=fv_full[invinds] + rhsbc["fv"],
        fp=fp_cond + rhsbc["fp"],
        invinds=invinds,
        bcinds=bcinds,
        bcvals=bcvals,
        fv_body_full=fv_full,
        fp_body_full=fp_full,
        elem_tensors=mats.pop("_elem", None),
        gradvsymmtrc=gradvsymmtrc,
        device=device,
    )
    if dircntrl:
        prob.dircntrl = dircntrl
    if bccontrol and "amatrob" in mats:
        from ..ops.condense import condense_velmat

        Arob, fvrob = condense_velmat(
            mats["amatrob"], dbcinds=[dbcinds], dbcvals=[dbcvals]
        )
        if np.linalg.norm(fvrob) > 1e-15:
            raise UserWarning("dirichlet and control bcs must not intersect")
        prob.Arob = Arob
        prob.Brob = mats["bmatrob"][invinds, :]
    if geo.liftdrag_tag is not None:
        nodes = space.boundary_nodes(geo.liftdrag_tag)
        prob.ldsbcinds = np.concatenate(
            [dim * nodes + c for c in range(dim)])
    return prob
