"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Two kernels:

* the dense inverse apply ``y = x @ KT`` (``csrc/vecmat.cu``), the
  counterpart of the JAX package's Pallas kernel
  ``ops/pallas_kernels.py: vecmat_pallas``.  It streams the full dense
  saddle inverse from device memory once per time step — the bandwidth
  floor of the dense-solver time loop.
* the fused element pipeline of the convection vector
  (``csrc/convection.cu``): gather, quadrature and a fixed-order reduction
  in two launches, behind :func:`conv_vector` and
  :func:`conv_vector_amatvec`.  It is the kernel the JAX package probed
  for (``tools/probe_pallas_gather.py``: a gather inside a kernel body)
  and had to leave to XLA.

Build and binding: each ``csrc/*.cu`` is compiled at first use by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface (under
``build/kernels/``) and loaded with ``ctypes``.  Nothing is built or
imported at module import, so the module imports on a machine without a
CUDA toolkit.

Contract of every wrapper here: a tensor on the CPU takes the plain
version; a CUDA tensor launches the kernel or raises — there is no
fallback from a failed build or launch to the plain version.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

_CSRC = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "csrc"))
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
_LIBS = {}

# rows of x staged in shared memory per block: 4096 doubles = 32 KB, below
# the 48 KB a block gets without opting in to more
_MAX_ROWS_PER_SPLIT = 4096
_ROW_UNROLL = 8           # UNROLL in csrc/vecmat.cu
_COLS_PER_BLOCK = 256     # THREADS * VEC at the common 8-byte load width


def build_dir():
    """Where the kernels' shared libraries go (``DNS_TORCH_BUILD_DIR`` or
    ``build/kernels`` beside the package)."""
    return os.environ.get("DNS_TORCH_BUILD_DIR") or os.path.normpath(
        os.path.join(_CSRC, "..", "..", "build", "kernels"))


def _nvcc():
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        if not os.path.exists(cand):
            raise RuntimeError(
                "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                "the CUDA kernels cannot be built on this machine")
    return cand


def _lib_path(name):
    src = os.path.join(_CSRC, name + ".cu")
    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(_NVCC_FLAGS).encode())
    return src, os.path.join(build_dir(),
                             f"lib{name}_{tag.hexdigest()[:12]}.so")


def _start_build(name, extra_flags=()):
    """Start ``nvcc`` for one source unless its library exists already.
    Returns ``(lib, tmp, process or None)``."""
    src, lib = _lib_path(name)
    if os.path.exists(lib):
        return lib, None, None
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [_nvcc(), *_NVCC_FLAGS, *extra_flags, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib, tmp, proc


def _finish_build(name, lib, tmp, proc):
    """Wait for one build; raises with the compiler's output on failure.
    Returns the compiler's output (``-Xptxas -v`` statistics go there)."""
    if proc is None:
        return ""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)      # atomic: no process loads a half-written file
    return out


def build_all(extra_flags=()):
    """Build every ``csrc/*.cu`` — one ``nvcc`` per source, all started
    together.  Returns ``{name: compiler output}``."""
    names = sorted(f[:-3] for f in os.listdir(_CSRC) if f.endswith(".cu"))
    started = [(n, *_start_build(n, extra_flags)) for n in names]
    return {n: _finish_build(n, lib, tmp, proc)
            for n, lib, tmp, proc in started}


def _load(name):
    """The ctypes library of ``csrc/<name>.cu``, built at first use."""
    if name not in _LIBS:
        _finish_build(name, *_start_build(name))
        _LIBS[name] = ctypes.CDLL(_lib_path(name)[1])
    return _LIBS[name]


def _vecmat_lib():
    lib = _load("vecmat")
    if not getattr(lib, "_dns_typed", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.vecmat_f32, lib.vecmat_f64):
            fn.argtypes = [ptr, ptr, ptr, ptr, i, i, i, i, ptr]
            fn.restype = i
        lib.vecmat_error_string.argtypes = [i]
        lib.vecmat_error_string.restype = ctypes.c_char_p
        lib._dns_typed = True
    return lib


def vecmat_plan(m, n, sm_count):
    """``(splits, rows_per_split)`` of the contraction for an ``(m, n)``
    operand: enough blocks to fill the card several times over, slabs of
    at least a few unrolled row groups, at most what fits shared memory."""
    col_tiles = -(-n // _COLS_PER_BLOCK)
    splits = -(-8 * sm_count // col_tiles)
    splits = max(1, min(splits, m // (4 * _ROW_UNROLL)))
    rows = -(-m // splits)
    rows = min(-(-rows // _ROW_UNROLL) * _ROW_UNROLL, _MAX_ROWS_PER_SPLIT)
    return -(-m // rows), rows


@functools.lru_cache(maxsize=None)
def _vecmat_plan_on(m, n, device):
    # cached: the device query costs more host time than the launch itself
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return vecmat_plan(m, n, sms)


def vecmat_ref(x, KT):
    """Plain PyTorch version of :func:`vecmat`: ``x (m,) @ KT (m, n)``."""
    return x @ KT


def vecmat(x, KT):
    """``x (m,) @ KT (m, n) -> (n,)`` accumulated in the operands' type
    (f32 or f64), any ``m, n``; pass ``KT = K.T`` (contiguous) to compute
    ``K @ x``.

    On a CUDA tensor this launches the hand-written kernel of
    ``csrc/vecmat.cu`` on the current stream (and counts the launch in
    ``vecmat.launches``); on a CPU tensor it is :func:`vecmat_ref`.
    """
    if x.dim() != 1 or KT.dim() != 2 or KT.shape[0] != x.shape[0]:
        raise ValueError(f"vecmat: x {tuple(x.shape)} @ KT {tuple(KT.shape)}")
    if x.dtype != KT.dtype or x.device != KT.device:
        raise ValueError(
            f"vecmat: x is {x.dtype} on {x.device}, "
            f"KT is {KT.dtype} on {KT.device}")
    if not x.is_cuda:
        return vecmat_ref(x, KT)
    if KT.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"vecmat kernel takes f32 or f64, not {KT.dtype}")
    if not KT.is_contiguous():
        raise ValueError("vecmat kernel needs a contiguous row-major KT "
                         "(store the transposed inverse once, at setup)")
    m, n = KT.shape
    if m == 0 or n == 0 or m >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"vecmat kernel: unsupported shape {(m, n)}")
    x = x.contiguous()
    lib = _vecmat_lib()
    fn = lib.vecmat_f32 if KT.dtype == torch.float32 else lib.vecmat_f64
    with torch.cuda.device(KT.device):
        splits, rows = _vecmat_plan_on(m, n, KT.device)
        y = torch.empty(n, dtype=KT.dtype, device=KT.device)
        part = (torch.empty((splits, n), dtype=KT.dtype, device=KT.device)
                if splits > 1 else y)
        err = fn(x.data_ptr(), KT.data_ptr(), y.data_ptr(), part.data_ptr(),
                 m, n, splits, rows,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"vecmat kernel launch failed for shape {(m, n)}: "
            f"{lib.vecmat_error_string(err).decode()}")
    vecmat.launches += 1
    return y


vecmat.launches = 0


# ---------------------------------------------------------------------------
# the convection element pipeline
# ---------------------------------------------------------------------------

def dof_slot_table(ids, nseg):
    """CSR table of a fixed-order segment sum: for each segment
    ``i < nseg`` the flat positions ``k`` with ``ids.ravel()[k] == i``, in
    ascending order; ids outside ``[0, nseg)`` (the dropped padding
    segment) get no entry.  Returns ``(rowptr (nseg+1,), slots)`` as int32
    numpy arrays."""
    ids = np.asarray(ids).ravel()
    order = np.argsort(ids, kind="stable")
    sid = ids[order]
    keep = (sid >= 0) & (sid < nseg)
    rowptr = np.searchsorted(sid[keep], np.arange(nseg + 1))
    return rowptr.astype(np.int32), order[keep].astype(np.int32)


def reduce_slots_ref(vals, rowptr, slots):
    """Plain PyTorch version of the kernel's reduction: ``out[i]`` is the
    sum of ``vals[slots[k]]`` for ``k`` in ``rowptr[i]:rowptr[i+1]``,
    added one after the other in that order."""
    rowptr, slots = rowptr.long(), slots.long()
    start, cnt = rowptr[:-1], rowptr[1:] - rowptr[:-1]
    out = torch.zeros(len(start), dtype=vals.dtype, device=vals.device)
    for k in range(int(cnt.max()) if len(cnt) else 0):
        m = cnt > k
        out[m] += vals[slots[start[m] + k]]
    return out


def weight_matrices(N2, dN2):
    """Constant weight matrices of the plain element pipelines, from the
    reference-element tables ``N2 (Q, nvpc)``, ``dN2 (Q, nvpc, dim)``
    (numpy; ``nd = dim*nvpc``):

    * ``W1 (nd, dim*Q)``: element dofs ``ue(a,c)`` -> values at quad
      points ``(q,c)``,
    * ``W2 (nd, dim*dim*Q)``: ``ue(a,c)`` -> reference-gradient components
      ``(q,k,c)``,
    * ``W3 (dim*Q, nd)``: weighted quad values ``(q,c)`` -> element load
      ``(a,c)``.
    """
    Q, nvpc, dim = dN2.shape
    nd = dim * nvpc
    W1 = np.zeros((nd, dim * Q), dtype=N2.dtype)
    W2 = np.zeros((nd, dim * dim * Q), dtype=N2.dtype)
    W3 = np.zeros((dim * Q, nd), dtype=N2.dtype)
    for q in range(Q):
        for a in range(nvpc):
            for c in range(dim):
                W1[dim * a + c, dim * q + c] = N2[q, a]
                W3[dim * q + c, dim * a + c] = N2[q, a]
                for k in range(dim):
                    W2[dim * a + c,
                       dim * dim * q + dim * k + c] = dN2[q, a, k]
    return W1, W2, W3


class DofTable:
    """An ``(n, nd)`` int64 table ``vd`` of full velocity-dof ids (id
    ``nseg`` = the dropped padding slot) with what the kernel reads of it:
    its int32 copy and the dof -> scratch-slot CSR of the fixed-order
    reduction, built once, at first use, and kept.  The element table of
    :class:`ConvTables` is one, the facet blocks' dof table another."""

    def __init__(self, vd, nseg):
        self.vd = vd
        self.nseg = nseg
        self._kernel_tables = None

    def with_dof_map(self, dofmap):
        """The table of a permuted state layout: ``dofmap (nseg+1,)`` old
        id -> new position, slot ``nseg`` staying the dropped one."""
        return DofTable(dofmap[self.vd.clamp(max=self.nseg)], self.nseg)

    def kernel_tables(self):
        """``(vd32 (n, nd), rowptr (nseg+1,), slots)`` int32 on the
        device: for each dof its ``(row, local slot)`` pairs as flat
        scratch positions ``r*nd + j``, ascending."""
        if self._kernel_tables is None:
            vd = self.vd.cpu().numpy()
            rowptr, slots = dof_slot_table(vd, self.nseg)
            self._kernel_tables = tuple(
                torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                                device=self.vd.device)
                for a in (vd, rowptr, slots))
        return self._kernel_tables


class ConvTables:
    """What the convection kernel and its plain version read, for one FEM
    space in one state layout.

    Tensors on ``device``: ``N2 (Q, nvpc)``, ``dN2 (Q, nvpc, dim)``,
    ``JinvT (nc, dim, dim)``, ``wdet (nc, Q)`` in ``dtype``; ``dofs``, the
    :class:`DofTable` of ``vd (nc, nd)`` int64 full velocity-dof ids
    (``nv_full`` = the dropped padding slot).  The Kronecker-expanded
    weight matrices ``W1 W2 W2T W3`` that only the plain version reads are
    built by :meth:`plain_weights` at its first call.
    """

    def __init__(self, **kw):
        self.__dict__.update(kw)
        self.nd = self.nvpc * self.dim
        self.dofs = DofTable(self.vd, self.nv_full)
        self._plain = None

    @property
    def dtype(self):
        return self.wdet.dtype

    @property
    def device(self):
        return self.wdet.device

    def with_vd(self, vd):
        """Clone over another dof table (a permuted state layout); the
        reduction table is rebuilt for it at first use."""
        new = ConvTables(**{**{k: v for k, v in self.__dict__.items()
                               if k not in ("dofs", "_plain")}, "vd": vd})
        new._plain = self._plain
        return new

    def kernel_tables(self):
        """The element table's :meth:`DofTable.kernel_tables`."""
        return self.dofs.kernel_tables()

    def plain_weights(self):
        """``(W1, W2, W2T, W3)`` of :func:`weight_matrices` on the device
        in ``dtype``."""
        if self._plain is None:
            W1, W2, W3 = weight_matrices(self.N2.cpu().numpy(),
                                         self.dN2.cpu().numpy())
            self._plain = tuple(
                torch.as_tensor(np.ascontiguousarray(a), device=self.device)
                for a in (W1, W2, W2.T, W3))
        return self._plain


def _fields_at_quad(t, u_full, grads=True):
    """-> ``(uq (nc,Q,dim), guq (nc,Q,dim,dim) or None)``."""
    Q, dim = t.Q, t.dim
    dt = t.dtype
    upad = torch.cat([u_full.to(dt), u_full.new_zeros(1, dtype=dt)])
    ue = upad[t.vd]                                          # (nc,nd)
    W1, W2, _, _ = t.plain_weights()
    uq = (ue @ W1).reshape(t.nc, Q, dim)
    if not grads:
        return uq, None
    rg = (ue @ W2).reshape(t.nc, Q, dim, dim)
    guq = torch.einsum("edk,eqkc->eqcd", t.JinvT, rg)
    return uq, guq


def _scatter(vals, ids, nseg):
    """Scatter-add ``vals`` into ``nseg`` segments (``index_add_``: in
    index order on the CPU, which is the kernel's fixed order)."""
    out = torch.zeros(nseg, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, ids, vals)


def conv_vector_ref(u1, u2, tables):
    """Plain PyTorch version of :func:`conv_vector`: gather, two
    constant-weight matmuls, small einsums, one scatter-add."""
    t = tables
    u1q, gu1q = _fields_at_quad(t, u1)
    u2q = u1q if u2 is None else _fields_at_quad(t, u2, grads=False)[0]
    conv = torch.einsum("eqd,eqcd->eqc", u2q, gu1q)
    wconv = (t.wdet[:, :, None] * conv).reshape(t.nc, t.dim * t.Q)
    fe = wconv @ t.plain_weights()[3]
    out = _scatter(fe.reshape(-1), t.vd.reshape(-1), t.nv_full + 1)
    return out[: t.nv_full].to(u1.dtype)


def conv_vector_amatvec_ref(u, nu, sym, tables, fac_elem=None,
                            fac_vdofs=None):
    """Plain PyTorch version of :func:`conv_vector_amatvec`."""
    t = tables
    dt = t.dtype
    _, _, W2T, W3 = t.plain_weights()
    uq, guq = _fields_at_quad(t, u)
    # convection load
    conv = torch.einsum("eqd,eqcd->eqc", uq, guq)
    wconv = (t.wdet[:, :, None] * conv).reshape(t.nc, t.dim * t.Q)
    fe_c = wconv @ W3
    # stiffness load: F = nu (grad u (+ grad u^T)), pulled back
    F = guq + guq.transpose(2, 3) if sym else guq
    G = torch.einsum("edk,eqcd->eqkc", t.JinvT, F)
    G = (float(nu) * t.wdet[:, :, None, None]
         * G).reshape(t.nc, t.dim * t.dim * t.Q)
    fe_a = G @ W2T

    off = t.nv_full + 1
    flat = t.vd.reshape(-1)
    vals = [fe_c.reshape(-1), fe_a.reshape(-1)]
    ids = [flat, flat.clamp(max=t.nv_full) + off]
    if fac_elem is not None and fac_elem.shape[0]:
        xfe = torch.cat([u.to(dt), u.new_zeros(1, dtype=dt)])[fac_vdofs.vd]
        ffe = torch.einsum("fab,fb->fa", fac_elem.to(dt), xfe)
        vals.append(ffe.reshape(-1))
        ids.append(fac_vdofs.vd.reshape(-1).clamp(max=t.nv_full) + off)
    out = _scatter(torch.cat(vals), torch.cat(ids), 2 * off)
    return (out[: t.nv_full].to(u.dtype),
            out[off: off + t.nv_full].to(u.dtype))


def _conv_lib():
    lib = _load("convection")
    if not getattr(lib, "_dns_typed", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.convection_th2d.argtypes = (
            [i, i, i] + [ptr] * 7 + [i, i, ctypes.c_double, i, ptr, ptr, i]
            + [ptr] * 8)
        lib.convection_th2d.restype = i
        lib.convection_error_string.argtypes = [i]
        lib.convection_error_string.restype = ctypes.c_char_p
        lib._dns_typed = True
    return lib


def _check_state(name, u, t, what="u"):
    if not torch.is_tensor(u) or u.dim() != 1 or u.shape[0] != t.nv_full:
        raise ValueError(
            f"{name}: {what} must be a 1-D tensor of the {t.nv_full} full "
            f"velocity dofs, got {tuple(getattr(u, 'shape', ()))}")
    if u.device != t.device:
        raise ValueError(f"{name}: {what} is on {u.device}, the tables are "
                         f"on {t.device}")


def _check_facets(name, t, fac_elem, fac_vdofs):
    """-> number of facet blocks (0 for none)."""
    if fac_elem is None or fac_elem.shape[0] == 0:
        return 0
    nfac = fac_elem.shape[0]
    if torch.is_tensor(fac_vdofs):
        raise TypeError(
            f"{name}: fac_vdofs must be a DofTable (wrap the index tensor "
            "once, where it is built: the kernel's tables are kept on it)")
    if (fac_vdofs is None or tuple(fac_elem.shape) != (nfac, t.nd, t.nd)
            or tuple(fac_vdofs.vd.shape) != (nfac, t.nd)
            or fac_vdofs.nseg != t.nv_full):
        got = (None if fac_vdofs is None
               else (tuple(fac_vdofs.vd.shape), fac_vdofs.nseg))
        raise ValueError(
            f"{name}: fac_elem {tuple(fac_elem.shape)} needs a fac_vdofs "
            f"table ({nfac}, {t.nd}) over {t.nv_full} dofs, got {got}")
    return nfac


def _conv_launch(name, t, u1, u2, fused, nu=0.0, sym=False, fac_elem=None,
                 fac_vdofs=None, nfac=0):
    """Launch ``csrc/convection.cu`` on the current stream; returns the
    ``(1 + fused, nv_full)`` output in ``u1``'s type."""
    ok = (torch.float32, torch.float64)
    if t.dtype not in ok or u1.dtype not in ok:
        raise TypeError(f"{name} kernel takes f32 or f64, not tables "
                        f"{t.dtype} / state {u1.dtype}")
    if (t.nvpc, t.Q, t.dim) != (6, 7, 2):
        raise NotImplementedError(
            f"{name} kernel: only the 2D Taylor-Hood instantiation (nvpc 6, "
            f"Q 7, dim 2) is built, not {(t.nvpc, t.Q, t.dim)}")
    lib = _conv_lib()
    with torch.cuda.device(t.device):
        vd32, rowptr, slots = t.kernel_tables()
        fptrs = (None, None, None, None)
        if nfac:
            fvd32, frowptr, fslots = fac_vdofs.kernel_tables()
            fac_elem = fac_elem.to(t.dtype).contiguous()
            fptrs = (fac_elem.data_ptr(), fvd32.data_ptr(),
                     frowptr.data_ptr(), fslots.data_ptr())
        u1 = u1.contiguous()
        if u2 is not None:
            u2 = u2.contiguous()
        nout = 2 if fused else 1
        scratch = torch.empty(nout * t.nc * t.nd + nfac * t.nd,
                              dtype=t.dtype, device=t.device)
        out = torch.empty((nout, t.nv_full), dtype=u1.dtype, device=t.device)
        err = lib.convection_th2d(
            int(t.dtype == torch.float64), int(u1.dtype == torch.float64),
            int(fused), u1.data_ptr(),
            None if u2 is None else u2.data_ptr(), vd32.data_ptr(),
            t.JinvT.data_ptr(), t.wdet.data_ptr(), t.N2.data_ptr(),
            t.dN2.data_ptr(), t.nc, t.nv_full, float(nu), int(bool(sym)),
            fptrs[0], fptrs[1], nfac, scratch.data_ptr(), rowptr.data_ptr(),
            slots.data_ptr(), fptrs[2], fptrs[3], out[0].data_ptr(),
            out[nout - 1].data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed (nc {t.nc}, nv_full {t.nv_full}, "
            f"{nfac} facet blocks): "
            f"{lib.convection_error_string(err).decode()}")
    return out


def conv_vector(u1, u2, tables):
    """The convection vector ``int ((u2 . grad) u1) . phi dx`` over the
    full velocity dofs; ``u2=None`` means ``u2 = u1``.  Arithmetic in
    ``tables.dtype``, result in ``u1``'s type.

    On a CUDA tensor this launches the hand-written kernel of
    ``csrc/convection.cu`` (element kernel + fixed-order reduction) on the
    current stream and counts it in ``conv_vector.launches``; on a CPU
    tensor it is :func:`conv_vector_ref`.
    """
    _check_state("conv_vector", u1, tables, "u1")
    if u2 is not None:
        _check_state("conv_vector", u2, tables, "u2")
        if u2.dtype != u1.dtype:
            raise ValueError(f"conv_vector: u1 is {u1.dtype}, u2 {u2.dtype}")
    if not u1.is_cuda:
        return conv_vector_ref(u1, u2, tables)
    out = _conv_launch("conv_vector", tables, u1, u2, fused=False)
    conv_vector.launches += 1
    return out[0]


conv_vector.launches = 0


def conv_vector_amatvec(u, nu, sym, tables, fac_elem=None, fac_vdofs=None):
    """Fused ``(N(u)u, A u)`` over the full velocity dofs in one element
    pass: the stiffness load ``nu (grad u (+ grad u^T))`` shares the gather
    and the gradients with the convection load; ``fac_elem (nfac, nd, nd)``
    / ``fac_vdofs``, the :class:`DofTable` of their ``(nfac, nd)`` dof ids,
    are optional facet blocks added into ``A u``.  ``nu`` is a host scalar.  Returns ``(conv, av)`` in ``u``'s
    type.

    On a CUDA tensor this launches the kernel of ``csrc/convection.cu``
    and counts it in ``conv_vector_amatvec.launches``; on a CPU tensor it
    is :func:`conv_vector_amatvec_ref`.
    """
    name = "conv_vector_amatvec"
    _check_state(name, u, tables)
    nfac = _check_facets(name, tables, fac_elem, fac_vdofs)
    if not u.is_cuda:
        return conv_vector_amatvec_ref(u, nu, sym, tables, fac_elem,
                                       fac_vdofs)
    out = _conv_launch(name, tables, u, None, fused=True, nu=nu, sym=sym,
                       fac_elem=fac_elem, fac_vdofs=fac_vdofs, nfac=nfac)
    conv_vector_amatvec.launches += 1
    return out[0], out[1]


conv_vector_amatvec.launches = 0
