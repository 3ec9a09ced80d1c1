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

On the card one :meth:`BandedConvTail.vector` is three launches: ``G``'s
product (:func:`..ops.kernels.rect_mv` on int8 blocks, the f64 state read
straight from the carry), the quadrature (:func:`..ops.kernels.conv_quad`,
``csrc/convection.cu``) and ``S``'s product into the interior rows of a
buffer whose bc rows are zero.  The tail trades the index pipeline's
latency for bytes: :func:`build_banded_conv_tail` predicts the windows'
bytes before it allocates and returns ``None`` (the caller keeps the
index pipeline, :func:`..ops.kernels.conv_vector`) unless the banded
stream is predicted to win.

The JAX package's ``DNS_TPU_BANDED_CONV*`` environment variables are
constants here: the store and the cost model follow the device
(:data:`GATE`), ``force`` and ``max_gb`` are keywords of
:func:`build_banded_conv_tail`.
"""

import numpy as np
import torch

from ..device import resolve_device
from .kernels import as_band_operand, conv_quad, rect_mv

_LANE = 128
_BS = 256

# The banded-vs-index cost model: the banded tail streams ``nbytes`` at
# ``stream_floor_gbps``; the index pipeline costs ``index_us_per_1k_vals``
# per 1000 element values (nvals = nc * nd); the banded form must win by
# the margin.  The CPU constants are the JAX package's (set on a TPU v5e,
# its ``banded_conv.py``), so both packages decide alike in the tests.
# The card's were measured on an H100 80GB HBM3 at 700.00 W by
# ``chip_smoke.py`` (phase ``banded_conv_path``, graph replay): the int8
# ``rect_mv`` products of G and S streamed 24.2 MB in 26.8 us at wake level
# 1 (0.90 TB/s) and 131.9 MB in 105.7 us at level 2 (1.25 TB/s, taken
# here); B5's convection vector took 4.40 us for 22 104 element values at
# level 1 (0.199 us per 1000, taken here) and 5.38 us for 80 136 at level
# 2 (0.067).  Each choice is the one that favours the tail; it still loses
# by 4x and more at both levels (``PERF.md``, section 6).
VALS_PER_DOF_2D = 3.16
GATE = {
    "cpu": dict(stream_floor_gbps=600.0,
                index_us_per_1k_vals=46.0 / VALS_PER_DOF_2D,
                win_margin=0.8, store="f32", max_gb=1.0),
    "cuda": dict(stream_floor_gbps=1248.0, index_us_per_1k_vals=0.199,
                 win_margin=0.8, store="int8", max_gb=1.0),
}
_STORE = {"int8": torch.int8, "f32": torch.float32}


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


def banded_wins(nbytes, nvals=None, ndofs=None, consts=None):
    """True when the banded stream is predicted to beat the index pipeline
    by the margin (``consts``: :func:`gate_constants`, the CPU's by
    default)."""
    c = gate_constants("cpu") if consts is None else consts
    return (banded_stream_us(nbytes, c["stream_floor_gbps"])
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

    ``Sb``/``Gb``: the static-window blocks (:func:`..ops.kernels.rect_mv`
    storage, 0/1 entries in ``store``), ``Sbases``/``Gbases`` their window
    starts on the device; ``kern``: the element-sorted kernel (``eorder``
    its order); ``ue_bc (nc, nd)``: the constant element field of the bc
    tail; ``windows``: the JAX package's ``(Sbases, wS, Spad, Gbases, wG,
    Gpad)``."""

    def __init__(self, kern, Sb, Sbases, Gb, Gbases, ue_bc, nin, nvals,
                 store, eorder=None, windows=None):
        self.kern, self.Sb, self.Gb, self.ue_bc = kern, Sb, Gb, ue_bc
        self.Sbases, self.Gbases = Sbases, Gbases
        self.nin, self.nvals, self.store = int(nin), int(nvals), store
        self.eorder, self.windows = eorder, windows
        self.nv_full = kern.nv_full
        # the output: S writes the interior rows, the bc rows stay zero
        self._y = torch.zeros(self.nv_full, dtype=kern.tables.dtype,
                              device=kern.device)

    @property
    def nbytes(self):
        """Bytes of the stored S and G blocks."""
        return sum(b.numel() * b.element_size() for b in (self.Sb, self.Gb))

    def vector(self, v_w):
        """The convection vector of the w-space state ``v_w``: the tail's
        own buffer, overwritten by its next call."""
        t = self.kern.tables
        x = v_w[: self.nin]
        if self.Gb.dtype != torch.int8:
            # int8 blocks take the f64 state (rounded to the tables' type
            # as the element field is formed); the others the work type
            x = x.to(t.dtype)
        ue = rect_mv(self.Gb, self.Gbases, x, self.nvals)
        fe = conv_quad(ue, self.ue_bc, t)
        rect_mv(self.Sb, self.Sbases, fe, self.nin, out=self._y[: self.nin])
        return self._y


def build_banded_conv_tail(kern, nin, bc_tail, max_gb=None, force=False):
    """Build the banded convection tail of a w-space kernel.

    ``kern``: the :class:`..ops.convection.ConvectionKernel` re-indexed
    with ``with_dof_map`` (w-space ids: ``[0, nin)`` RCM interior, ``[nin,
    nv_full)`` the bc tail); ``nin``: the interior rows; ``bc_tail
    (nv_full - nin,)``: the constant bc values of the w-space state.

    The blocks are stored as :data:`GATE` says for the kernel's device
    (int8 on the card, f32 on the CPU).  Returns ``None`` — the caller
    keeps the index pipeline — for f64 tables (the JAX package's gate
    refuses its f64 kernels), or when the predicted bytes exceed
    ``max_gb`` (default :data:`GATE`'s) or lose to the index pipeline
    under :func:`gate_constants` of the kernel's device; ``force`` builds
    it regardless.
    """
    t = kern.tables
    if t.dtype == torch.float64 and not force:
        return None
    consts = gate_constants(kern.device)
    if max_gb is not None:
        consts["max_gb"] = max_gb
    nv_full, (nc, nd) = kern.nv_full, tuple(t.vd.shape)
    vd = t.vd.cpu().numpy()
    eorder, rows, cols, keep = tail_patterns(vd, nin)
    nvals = nc * nd
    sdt = _STORE[consts["store"]]
    bfac, bs = sdt.itemsize / 4.0, _BS
    nblk_s = max(1, (nin + bs - 1) // bs)
    nblk_g = max(1, (nvals + bs - 1) // bs)
    by = bfac * (_window_bytes(rows[keep], cols[keep], nblk_s, bs)
                 + _window_bytes(cols[keep], rows[keep], nblk_g, bs))
    if not force and (by > consts["max_gb"] * 1e9
                      or not banded_wins(by, nvals=nvals, consts=consts)):
        return None

    import scipy.sparse as sps

    from ..solve.sadpnt import _build_banded_rect

    ones = np.ones(int(keep.sum()), np.float32)
    dev = kern.device
    S = sps.coo_matrix((ones, (rows[keep], cols[keep])),
                       shape=(nin, nvals)).tocsr()
    Sb, Sbases, wS, Spad = _build_banded_rect(S, np.arange(nin),
                                              np.arange(nvals), bs)
    G = sps.coo_matrix((ones, (cols[keep], rows[keep])),
                       shape=(nvals, nin)).tocsr()
    Gb, Gbases, wG, Gpad = _build_banded_rect(G, np.arange(nvals),
                                              np.arange(nin), bs)

    def bases(b):
        return torch.as_tensor(np.asarray(b, np.int32), device=dev)

    # the constant element field of the frozen bc tail
    vpad = np.zeros(nv_full + 1)
    vpad[nin:nv_full] = np.asarray(
        bc_tail.cpu() if torch.is_tensor(bc_tail) else bc_tail,
        dtype=np.float64).ravel()
    ue_bc = torch.as_tensor(vpad[np.minimum(vd[eorder], nv_full)]).to(
        device=dev, dtype=t.dtype).contiguous()
    return BandedConvTail(
        kern.with_element_order(eorder),
        as_band_operand(torch.from_numpy(Sb), dtype=sdt, device=dev),
        bases(Sbases),
        as_band_operand(torch.from_numpy(Gb), dtype=sdt, device=dev),
        bases(Gbases), ue_bc, nin, nvals, consts["store"], eorder=eorder,
        windows=(Sbases, int(wS), int(Spad), Gbases, int(wG), int(Gpad)))
