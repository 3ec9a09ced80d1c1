"""Seeded inputs and digests shared by ``chip_smoke.py`` and
``tools_torch/tail_vecmat_t.py``: the records ``TAIL_BITS`` and
``VECMAT_T_BITS`` are digests of kernels' outputs on these inputs.

The seeded values come from integer hashing on the card, so they are the
same under any torch version.  Nothing of the port is imported at import
time: ``wspace_kernel`` imports it when called, so a tool that puts another
checkout first on ``sys.path`` gets that checkout's.
"""

import hashlib

import numpy as np
import torch


def seeded(n, seed, device, dtype=torch.float64, offset=0):
    """``n`` values in [-0.5, 0.5) from an integer hash of their index and
    ``seed`` (exact integer arithmetic: the same bits on any device and
    torch version)."""
    i = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    h = (i * 2654435761 + (seed + 1) * 40503) & 0xFFFFFFFF
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & 0xFFFFFFFF
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & 0xFFFFFFFF
    h = h ^ (h >> 16)
    return (h.to(torch.float64) / 2.0 ** 32 - 0.5).to(dtype)


def seeded_operand(kernels, m, n, seed, device, rows=2048):
    """An ``(m, n)`` f32 :func:`vecmat_operand` whose entry ``(r, c)`` is
    ``seeded`` value ``r n + c``, filled a slab of rows at a time."""
    KT = kernels.vecmat_operand(m, n, torch.float32, device)
    for r0 in range(0, m, rows):
        r1 = min(m, r0 + rows)
        KT[r0:r1] = seeded((r1 - r0) * n, seed, device, torch.float32,
                           offset=r0 * n).reshape(r1 - r0, n)
    return KT


def digest(t):
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    a = t.detach().contiguous().cpu().numpy()
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def wspace_kernel(prob, dt, dev):
    """The default call's w-space convection kernel (f32 tables) and bc
    values, in the order of its block-Schur solver (``_cnab_wspace``)."""
    from dolfin_navier_scipy_tpu_torch.solve.timeint import _build_ops

    ops = _build_ops(prob, dt, theta=0.5, linsolver="schur", layout="full",
                     device=dev)
    slv = ops.solver
    nf, nin = prob.nv_full, slv._nin
    wsrc = np.concatenate([slv.permf.cpu().numpy(), np.setdiff1d(
        np.arange(nf), np.asarray(prob.invinds))]).astype(np.int64)
    iposx = np.full(nf + 1, nf, np.int64)
    iposx[wsrc] = np.arange(nf)
    kern = prob.conv_kernel_on(torch.float32).with_dof_map(
        torch.as_tensor(iposx, device=dev))
    return kern, nin, np.asarray(prob.bc_full_vec()).ravel()[wsrc]


def tail_state(vbc, nin, seed, dev):
    """A w-space state: the real constant bc tail, a seeded interior."""
    v = torch.as_tensor(np.asarray(vbc, np.float64)).to(dev)
    v[:nin] = seeded(nin, seed, dev)
    return v
