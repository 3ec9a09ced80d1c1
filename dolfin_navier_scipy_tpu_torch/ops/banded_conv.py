"""Banded-matvec convection tail for the permuted (w-space) CNAB step.

Twin of the JAX package's ``ops/banded_conv.py``.  With the elements
sorted along the RCM state order, the 0/1 scatter matrix ``S (nin,
nc*nd)`` and gather matrix ``G (nc*nd, nin)`` of the convection element
pipeline are banded in the static-window sense of the solver's blocks, so

    c(v)[:nin] = S @ quad(G @ v[:nin] + ue_bc)

— two static-window products and the per-element quadrature, with no
gather and no scatter.  Two w-space facts keep the windows tight (both
relied on by :func:`..solve.timeint.cnab`'s w-space step): the solver
reads only ``rhs[:nin]``, so ``S`` drops the bc rows; and the bc tail of
the w-space state is constant through the loop, so the gather splits into
a banded interior part plus the constant element field ``ue_bc``.

Elements are sorted by the mean RCM position of their INTERIOR dofs
(bc-only elements last): the interior dofs of one element couple in F, so
each element's columns fit one F bandwidth.

On the CPU the tail keeps the JAX package's form: S and G as f32
static-window blocks (:func:`..ops.kernels.rect_mv`) around the quadrature
(:func:`..ops.kernels.conv_quad_ref`).  On the card it is one launch of
:func:`..ops.kernels.conv_tail` (``csrc/convection.cu``): G's product as
an indexed load of the state (G has one 1 a kept row), the quadrature,
and S's product as each interior row's slot sum in the order of the int8
band product that ran before (:func:`..ops.kernels.tail_slot_table`, built
from S's windows), so the vector keeps that product's bits; no band is
built or uploaded.  :func:`build_banded_conv_tail` predicts the tail's
cost and returns ``None`` (the caller keeps the index pipeline,
:func:`..ops.kernels.conv_vector`) unless the tail is predicted to win.

The JAX package's ``DNS_TPU_BANDED_CONV*`` environment variables are
constants here: the cost model and the tail's form follow the device
(:data:`GATE`); ``force`` and ``max_gb`` are keywords of
:func:`build_banded_conv_tail`.
"""

import numpy as np
import torch

from ..device import resolve_device
from .kernels import (as_band_operand, conv_quad_ref, conv_tail, rect_mv,
                      tail_slot_table)

_LANE = 128
_BS = 256

# The tail-vs-index cost model: the tail costs ``tail_us_per_1k_vals`` per
# 1000 element values (nvals = nc * nd) where that is given (the card's
# one-launch slot form), else it streams ``nbytes`` at ``stream_floor_gbps``
# (the CPU's f32 bands); the index pipeline costs ``index_us_per_1k_vals``;
# the tail must win by the margin.  The CPU constants are the JAX package's
# (set on a TPU v5e, its ``banded_conv.py``), so both packages decide alike
# in the tests.  The card's are graph-replayed readings on an H100 80GB
# HBM3 at 700.00 W (``tools_torch/tail_vecmat_t.py``) at wake level 2,
# 80 136 element values, where a launch's fixed cost weighs least: the
# tail's vector 6.618-6.652 us (level 1: 5.225-5.390 us for 22 104), B5's
# 5.393-5.418 us (level 1: 4.319-4.441), each the reading that favours the
# tail.  Both are one latency-bound launch, so the ratio, not the rate per
# value, is what holds at other sizes: the tail loses by 1.2x at both
# levels and the gate refuses it (``PERF.md``, section 6).
VALS_PER_DOF_2D = 3.16
TAIL_US_PER_1K_VALS = 6.618 / 80.136
B5_US_PER_1K_VALS = 5.418 / 80.136
GATE = {
    "cpu": dict(stream_floor_gbps=600.0,
                index_us_per_1k_vals=46.0 / VALS_PER_DOF_2D,
                win_margin=0.8, max_gb=1.0),
    "cuda": dict(tail_us_per_1k_vals=TAIL_US_PER_1K_VALS,
                 index_us_per_1k_vals=B5_US_PER_1K_VALS,
                 win_margin=0.8, max_gb=1.0),
}


def gate_constants(device=None):
    """The cost model's constants for ``device`` (``None``: the card)."""
    return dict(GATE["cuda" if resolve_device(device).type == "cuda"
                     else "cpu"])


def banded_stream_us(nbytes, stream_floor_gbps):
    """Predicted cost of one application streaming ``nbytes``."""
    return nbytes / (stream_floor_gbps * 1e9) * 1e6


def index_pipeline_us(index_us_per_1k_vals, nvals=None, ndofs=None):
    """Predicted cost of one application of the index pipeline; prefer
    ``nvals`` (element values), else a 2D-P2 estimate from the dofs."""
    if nvals is None:
        nvals = ndofs * VALS_PER_DOF_2D
    return index_us_per_1k_vals * nvals / 1000.0


def tail_us(nbytes, consts, nvals=None, ndofs=None):
    """Predicted cost of one tail vector under ``consts``: per element
    value where they give a rate for it, else the stream of ``nbytes``."""
    if "tail_us_per_1k_vals" in consts:
        return index_pipeline_us(consts["tail_us_per_1k_vals"], nvals=nvals,
                                 ndofs=ndofs)
    return banded_stream_us(nbytes, consts["stream_floor_gbps"])


def banded_wins(nbytes, nvals=None, ndofs=None, consts=None):
    """True when the tail is predicted to beat the index pipeline by the
    margin (``consts``: :func:`gate_constants`, the CPU's by default)."""
    c = gate_constants("cpu") if consts is None else consts
    return (tail_us(nbytes, c, nvals=nvals, ndofs=ndofs)
            <= c["win_margin"] * index_pipeline_us(
                c["index_us_per_1k_vals"], nvals=nvals, ndofs=ndofs))


def _window_bytes(rows, cols, nblk, bs):
    """Predicted f32 bytes of the banded blocks of a (rows, cols) 0/1
    pattern whose row blocks are ``bs`` wide — without allocating."""
    lo = np.full(nblk, np.iinfo(np.int64).max)
    hi = np.full(nblk, -1)
    blk = rows // bs
    np.minimum.at(lo, blk, cols)
    np.maximum.at(hi, blk, cols)
    spans = np.where(hi >= 0, hi - lo + 1, 1)
    w = int(np.ceil(spans.max() / _LANE)) * _LANE
    return nblk * bs * max(w, _LANE) * 4


def element_order(vd, nin):
    """The tail's element order: a stable argsort of each element's mean
    interior position (``vd (nc, nd)`` w-space ids, interior below
    ``nin``), elements without an interior dof last."""
    vd = np.asarray(vd)
    msk = vd < nin
    mpos = np.where(msk, vd, 0).sum(1) / np.maximum(msk.sum(1), 1)
    mpos[~msk.any(1)] = nin
    return np.argsort(mpos, kind="stable")


def tail_patterns(vd, nin):
    """``(eorder, rows, cols, keep)``: the element order and the 0/1
    pattern of ``S`` (``rows[keep]`` x ``cols[keep]``; ``G`` is its
    transpose) of a w-space element table ``vd (nc, nd)``."""
    eorder = element_order(vd, nin)
    rows = np.asarray(vd)[eorder].reshape(-1)
    cols = np.arange(rows.shape[0])
    return eorder, rows, cols, rows < nin


class BandedConvTail:
    """``vector(v_w) -> (nv_full,)`` convection loads in the w-space
    layout: the interior rows carry ``int ((v.grad)v).phi dx`` (equal to
    :meth:`..ops.convection.ConvectionKernel.vector` on ``[:nin]`` to
    round-off), the bc rows are zero (no caller reads them).  Output in the
    kernel's type.

    Two forms: the CPU's, ``Sb``/``Gb`` the static-window blocks
    (:func:`..ops.kernels.rect_mv` storage, 0/1 entries) and
    ``Sbases``/``Gbases`` their window starts on the device; the card's,
    ``slots`` the :func:`..ops.kernels.tail_slot_table` of S's windows on
    the device and no blocks.  ``kern``: the element-sorted kernel
    (``eorder`` its order); ``ue_bc (nc, nd)``: the constant element field
    of the bc tail; ``windows``: the JAX package's ``(Sbases, wS, Spad,
    Gbases, wG, Gpad)``."""

    def __init__(self, kern, Sb, Sbases, Gb, Gbases, ue_bc, nin, nvals,
                 eorder=None, windows=None, slots=None):
        self.kern, self.Sb, self.Gb, self.ue_bc = kern, Sb, Gb, ue_bc
        self.Sbases, self.Gbases, self.slots = Sbases, Gbases, slots
        self.nin, self.nvals = int(nin), int(nvals)
        self.eorder, self.windows = eorder, windows
        self.nv_full = kern.nv_full
        # the output: S writes the interior rows, the bc rows stay zero
        self._y = torch.zeros(self.nv_full, dtype=kern.tables.dtype,
                              device=kern.device)

    @property
    def nbytes(self):
        """Bytes of the tables that stand for S and G: the stored blocks,
        or the slot table and the sorted element ids."""
        if self.slots is not None:
            return 4 * (self.slots.numel() + self.nvals)
        return sum(b.numel() * b.element_size() for b in (self.Sb, self.Gb))

    def vector(self, v_w):
        """The convection vector of the w-space state ``v_w``: the tail's
        own buffer, overwritten by its next call."""
        t = self.kern.tables
        if self.slots is not None:
            conv_tail(v_w, self.ue_bc, t, self.slots,
                      out=self._y[: self.nin])
            return self._y
        x = v_w[: self.nin].to(t.dtype)
        ue = rect_mv(self.Gb, self.Gbases, x, self.nvals)
        fe = conv_quad_ref(ue, self.ue_bc, t)
        rect_mv(self.Sb, self.Sbases, fe, self.nin, out=self._y[: self.nin])
        return self._y


def _sorted_kernel(kern, nin, bc_tail, vd, eorder):
    """``(kern_s, ue_bc)``: the kernel in the element order ``eorder`` and
    the constant element field of the frozen bc tail ``bc_tail``."""
    nv_full, t = kern.nv_full, kern.tables
    vpad = np.zeros(nv_full + 1)
    vpad[nin:nv_full] = np.asarray(
        bc_tail.cpu() if torch.is_tensor(bc_tail) else bc_tail,
        dtype=np.float64).ravel()
    ue_bc = torch.as_tensor(vpad[np.minimum(vd[eorder], nv_full)]).to(
        device=kern.device, dtype=t.dtype).contiguous()
    return kern.with_element_order(eorder), ue_bc


def _slot_tail(kern, nin, bc_tail):
    """The card's form of the tail (on the kernel's device, so the CPU
    tests build it too): S's and G's windows, computed without a band, and
    the slot table of S's."""
    from ..solve.sadpnt import _rect_windows

    vd = kern.tables.vd.cpu().numpy()
    eorder, rows, cols, keep = tail_patterns(vd, nin)
    nvals = rows.shape[0]
    sw = _rect_windows(rows[keep], cols[keep], nin, nvals, _BS)
    gw = _rect_windows(cols[keep], rows[keep], nvals, nin, _BS)
    slots = tail_slot_table(rows, nin, sw[0], _BS)
    kern_s, ue_bc = _sorted_kernel(kern, nin, bc_tail, vd, eorder)
    return BandedConvTail(
        kern_s, None, None, None, None, ue_bc, nin, nvals, eorder=eorder,
        windows=(*sw, *gw), slots=torch.as_tensor(slots, device=kern.device))


def build_banded_conv_tail(kern, nin, bc_tail, max_gb=None, force=False):
    """Build the banded convection tail of a w-space kernel.

    ``kern``: the :class:`..ops.convection.ConvectionKernel` re-indexed
    with ``with_dof_map`` (w-space ids: ``[0, nin)`` RCM interior, ``[nin,
    nv_full)`` the bc tail); ``nin``: the interior rows; ``bc_tail
    (nv_full - nin,)``: the constant bc values of the w-space state.

    The form follows the kernel's device: f32 blocks on the CPU, the slot
    table on the card (:func:`_slot_tail`).  Returns ``None`` — the caller
    keeps the index pipeline — for f64 tables (the JAX package's gate
    refuses its f64 kernels), or when the tables' bytes exceed ``max_gb``
    (default :data:`GATE`'s) or the tail loses to the index pipeline under
    :func:`gate_constants` of the kernel's device; ``force`` builds it
    regardless.
    """
    t = kern.tables
    if t.dtype == torch.float64 and not force:
        return None
    consts = gate_constants(kern.device)
    if max_gb is not None:
        consts["max_gb"] = max_gb
    if kern.device.type == "cuda":
        tail = _slot_tail(kern, nin, bc_tail)
        by, nvals = tail.nbytes, tail.nvals
    else:
        vd = t.vd.cpu().numpy()
        eorder, rows, cols, keep = tail_patterns(vd, nin)
        nvals = rows.shape[0]
        nblk_s = max(1, (nin + _BS - 1) // _BS)
        nblk_g = max(1, (nvals + _BS - 1) // _BS)
        by = (_window_bytes(rows[keep], cols[keep], nblk_s, _BS)
              + _window_bytes(cols[keep], rows[keep], nblk_g, _BS))
    if not force and (by > consts["max_gb"] * 1e9
                      or not banded_wins(by, nvals=nvals, consts=consts)):
        return None
    if kern.device.type == "cuda":
        return tail

    import scipy.sparse as sps

    from ..solve.sadpnt import _build_banded_rect

    ones = np.ones(int(keep.sum()), np.float32)
    S = sps.coo_matrix((ones, (rows[keep], cols[keep])),
                       shape=(nin, nvals)).tocsr()
    Sb, Sbases, wS, Spad = _build_banded_rect(S, np.arange(nin),
                                              np.arange(nvals), _BS)
    G = sps.coo_matrix((ones, (cols[keep], rows[keep])),
                       shape=(nvals, nin)).tocsr()
    Gb, Gbases, wG, Gpad = _build_banded_rect(G, np.arange(nvals),
                                              np.arange(nin), _BS)
    kern_s, ue_bc = _sorted_kernel(kern, nin, bc_tail, vd, eorder)

    def operand(b):
        return as_band_operand(torch.from_numpy(b), device=kern.device)

    def bases(b):
        return torch.as_tensor(np.asarray(b, np.int32), device=kern.device)

    return BandedConvTail(
        kern_s, operand(Sb), bases(Sbases), operand(Gb), bases(Gbases),
        ue_bc, nin, nvals, eorder=eorder,
        windows=(Sbases, int(wS), int(Spad), Gbases, int(wG), int(Gpad)))
