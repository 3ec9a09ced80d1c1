"""Differentiable time integration: the discrete adjoint of the CNAB loop.

Twin of the JAX package's ``solve/adjoint.py``: the CNAB step on the
full-dof layout (the dense saddle inverse zero-padded onto the full dof
set, :func:`.timeint.build_full_layout`) written with differentiable
pieces, so ``torch.autograd`` through the step loop is the *exact discrete
adjoint* of the integrator — gradients of any functional of the final
state with respect to the initial state and a per-step control schedule,
in reverse mode (``backward``, ``torch.autograd.grad``) and in forward
mode (``torch.func.jvp``).

On the card the step runs hand-written kernels, which autograd cannot look
into; each is a ``torch.autograd.Function`` of :mod:`..ops.kernels` with a
backward kernel of its own:

* the fused convection and stiffness load (B5, ``conv_vector_amatvec``):
  :class:`..ops.kernels.ConvAmatvecFn`, backward ``conv_vjp``;
* the initial convection ``N(v0)v0`` (B5, ``conv_vector``):
  :class:`..ops.kernels.ConvVectorFn`, backward ``conv_vjp``;
* the dense inverse apply (B1, ``vecmat`` on ``ZpT``):
  :class:`..ops.kernels.VecmatFn`, backward ``vecmat_t`` (``ZpT @ g``: the
  exact transpose, never the inverse's symmetry).

Forward mode needs no kernel of its own (the ``Function``\\ s' ``jvp``
reuse the forward kernels).  On the CPU the same ``Function``\\ s reach the
plain versions.  The step is wrapped in ``torch.utils.checkpoint``
(``remat``), so reverse mode keeps the carries of each step and recomputes
the rest: memory O(n_steps * nf); forward mode stores nothing for a
backward pass and runs the steps as they are.  ``Zp`` is constant in time and state,
so differentiating through its apply is exact.

Precision: the convection tables follow the work type, as in both
packages' full-layout ``cnab`` (``timeint.py``): f32 tables under the f64
carry on the card (the increment-form accuracy model), f64 tables under
f64 work on the CPU.  The JAX package's ``make_diff_cnab`` takes its f32
tables under either work type; on the CPU the port's gradient is then
the f64 one, the reference the card's gradient is held to.
"""

import numpy as np
import scipy.sparse as sps
import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.kernels import ConvAmatvecFn, ConvVectorFn, VecmatFn


def _transformed(*ts):
    """Whether a tensor is under a functorch transform or carries a
    forward-mode tangent."""
    from torch._C._functorch import is_functorch_wrapped_tensor
    from torch.autograd.forward_ad import unpack_dual

    return any(is_functorch_wrapped_tensor(t)
               or unpack_dual(t).tangent is not None for t in ts)


def make_diff_cnab(prob, dt, bvec=None, theta=0.5, precision="accurate",
                   remat=True, device=None):
    """Differentiable CNAB simulator for gradient-based control/design.

    Parameters
    ----------
    prob : problem object (as for :func:`~.timeint.cnab`)
    dt : time step
    bvec : optional actuation vector over the FULL velocity dof set
        (``(nv_full,)``); the per-step forcing is ``fv + amps[i] * bvec``.
    precision : ``'accurate'`` (f64 carry; f64 work on the CPU, f32 work
        under the f64 carry on the card) or ``'fast'`` (f32 carry).
    remat : recompute each step in the backward pass
        (``torch.utils.checkpoint``; default True; reverse mode through
        ``torch.autograd`` only: forward mode and functorch transforms run
        the steps as they are).
    device : where it runs; ``None`` is the CUDA card.

    Returns
    -------
    sim : ``sim(v0, amps) -> v_inner (nin,)`` — the final inner velocity
        (a tensor on ``device``) after ``len(amps)`` CNAB steps from the
        inner state ``v0``, differentiable in both arguments.
    """
    from .timeint import _build_ops, _kern, build_full_layout

    device = resolve_device(device)
    ops = _build_ops(prob, dt, theta=theta, precision=precision,
                     linsolver="dense", device=device)
    fl = build_full_layout(prob, dt, ops, device)
    kern = _kern(prob, "fast" if ops.wdtype == torch.float32
                 else "accurate", device)
    tabs = kern.tables
    nf = fl["nf"]
    w = ops.wdtype
    cdtype = torch.float32 if precision == "fast" else torch.float64
    nu, sym = fl["nu"], fl["sym"]
    aff = fl["aff"]
    ZpT = fl["ZpT"]
    zdt = ZpT.dtype

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype=np.float64).ravel()).to(
            device=device, dtype=dtype)

    iv = torch.as_tensor(prob.invinds, dtype=torch.int64, device=device)
    vbc = dev(prob.bc_full_vec(), cdtype)
    fv = fl["fv"]
    fp = dev(prob.fp, w)
    bv = None if bvec is None else dev(bvec, w)
    # condensed J (over inner dofs) for the carried gp = Jc v0 —
    # differentiable in v0, so dense (np, nin) on the device
    Jin = torch.as_tensor(sps.csr_matrix(prob.Jc).toarray()).to(
        device=device, dtype=w)

    def step(vf, nfc_o, gp, amp):
        cv, av = ConvAmatvecFn.apply(vf, nu, sym, tabs, aff.fac_elem,
                                     aff.fac_dofs)
        nfc_c = (-cv).to(w)
        fv_t = fv if bv is None else fv + amp.to(w) * bv
        rhs = (-dt) * av.to(w) + (0.5 * dt) * (3.0 * nfc_c - nfc_o) \
            + dt * fv_t
        rp = (fp - gp).to(w)
        sol = VecmatFn.apply(torch.cat([rhs, rp]).to(zdt), ZpT)
        return vf + sol[:nf].to(vf.dtype), nfc_c

    def sim(v0, amps):
        v0 = torch.as_tensor(v0).to(device=device, dtype=cdtype)
        amps = torch.as_tensor(amps).to(device=device)
        # remat serves reverse mode; under a functorch transform or with
        # forward-mode duals there is no backward pass to store for
        rm = remat and not _transformed(v0, amps)
        vf = vbc.index_put((iv,), v0)
        gp = Jin @ v0.to(w)
        nfc = (-ConvVectorFn.apply(vf, tabs)).to(w)
        for i in range(amps.shape[0]):
            if rm:
                vf, nfc = checkpoint(step, vf, nfc, gp, amps[i],
                                     use_reentrant=False)
            else:
                vf, nfc = step(vf, nfc, gp, amps[i])
            gp = fp
        return vf[iv]

    return sim
