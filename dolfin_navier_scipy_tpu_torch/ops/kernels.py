"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Four sources:

* the dense inverse apply ``y = x @ KT`` (``csrc/vecmat.cu``), the
  counterpart of the JAX package's Pallas kernel
  ``ops/pallas_kernels.py: vecmat_pallas``.  It streams the full dense
  saddle inverse from device memory once per time step — the bandwidth
  floor of the dense-solver time loop.
* the fused element pipeline of the convection vector
  (``csrc/convection.cu``): gather, quadrature and a fixed-order reduction
  in one launch, behind :func:`conv_vector` and
  :func:`conv_vector_amatvec`.  It is the kernel the JAX package probed
  for (``tools/probe_pallas_gather.py``: a gather inside a kernel body)
  and had to leave to XLA.
* the banded and static-window block matvecs of the block-Schur solver
  (``csrc/bandmv.cu``: a warp-per-row kernel, and a bulk-copy ring kernel
  for single-level f32 operands too small in rows for the first to fill
  the card; :func:`bandmv_plan` picks) behind :func:`banded_mv`,
  :func:`rect_mv` and :func:`rect_mv_levels`: the JAX package's XLA
  einsums ``_banded_mv``, ``_rect_mv``, ``_rect_mv_pair`` and
  ``SchurSaddleSolver._sapply``.
* the affine element matvecs ``M x``, ``A x``, ``cm M x + ca A x``, ``J x``
  and ``J^T q`` (``csrc/affine.cu``) behind :func:`affine_mv`, and the
  dense solver's residual ``[K v + J^T q ; J v]`` behind
  :func:`affine_residual`: the JAX package's ``ops/affine.py:
  AffineVectorOps`` pipelines (left to XLA), one launch with the mode as
  an argument and no grid-wide wait (elements of a chunk and its halo in
  a block's shared memory, chunks sized by :func:`affine_plan`).

Build and binding: each ``csrc/*.cu`` is compiled at first use by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface (under
``build/kernels/``) and loaded with ``ctypes``.  Nothing is built or
imported at module import, so the module imports on a machine without a
CUDA toolkit.

Contract of every wrapper here: a tensor on the CPU takes the plain
version; a CUDA tensor launches the kernel or raises — there is no
fallback from a failed build or launch to the plain version.
"""

import collections
import contextlib
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

# How csrc/vecmat.cu cuts its operand, decided here alone: the build
# compiles it into the kernel (-DVECMAT_<key>) and vecmat_plan sizes the
# scratch and the shared memory from it.  Boxes of BOX_ROWS rows x GROUPS
# 16-byte column groups (64 KB), a ring of STAGES boxes, CONSUMERS threads
# that multiply-add.
_VECMAT_GEOMETRY = {"BOX_ROWS": 64, "GROUPS": 64, "STAGES": 3,
                    "CONSUMERS": 256}
# How csrc/bandmv.cu cuts its operands, decided here alone.  Compiled in
# (-DBANDMV_<key>): ROWS, the rows of a block of the warp-per-row kernel,
# and CONSUMERS, the threads of the ring kernel that multiply-add (besides
# one producer warp).  The rest feeds bandmv_plan: a single-level f32
# product takes the ring kernel where the warp-per-row kernel's grid
# (nblk * ceil(bs / ROWS) blocks) would have fewer than RING_GRID_BELOW
# blocks an SM, the warp-per-row kernel elsewhere; the ring kernel runs
# BLOCKS_PER_SM blocks an SM, units of about UNIT_BYTES (whole rows, one
# bulk copy each), at least MIN_UNITS a block where rows allow, a ring of
# about RING_BYTES.
_BANDMV_GEOMETRY = {"ROWS": 16, "CONSUMERS": 256}
_BANDMV_PLAN = {"RING_GRID_BELOW": 1, "BLOCKS_PER_SM": 1,
                "UNIT_BYTES": 48 * 1024, "RING_BYTES": 192 * 1024,
                "MIN_UNITS": 2}
# How stack_plan picks the kernel of a level stack (rect_mv_levels): the
# share kernel on SHARE_BLOCKS_PER_SM blocks an SM for a stack of one row
# block (S^-1, dense: its rows fill no grid of ROWS-row blocks evenly); the
# share kernel on blocks of SHARE_ROWS rows for stacks of SHARE_LEVELS or
# more levels whose window takes SHARE_WINDOW_BYTES or more (W at level
# 3); the ring (with the geometry above) for such stacks where the
# warp-per-row grid has fewer than RING_GRID_BELOW blocks an SM (W at
# level 1: a wave and a bit at three blocks an SM); the warp-per-row
# kernel elsewhere.  FORM, when set, forces one form.
_STACK_PLAN = {"FORM": None, "SHARE_BLOCKS_PER_SM": 2, "SHARE_LEVELS": 3,
               "SHARE_WINDOW_BYTES": 16 * 1024, "SHARE_ROWS": 8,
               "RING_GRID_BELOW": 4}
_SOURCE_FLAGS = {"vecmat": tuple(f"-DVECMAT_{k}={v}"
                                 for k, v in _VECMAT_GEOMETRY.items()),
                 "bandmv": tuple(f"-DBANDMV_{k}={v}"
                                 for k, v in _BANDMV_GEOMETRY.items())}
# the most shared memory one block may take (sm_90)
_SMEM_PER_BLOCK = 232448


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
    flags = [*_NVCC_FLAGS, *_SOURCE_FLAGS.get(name, ())]
    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(flags).encode())
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
        [_nvcc(), *_NVCC_FLAGS, *_SOURCE_FLAGS.get(name, ()), *extra_flags,
         "-o", tmp, src],
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
            fn.argtypes = [ptr] * 5 + [i] * 4 + [ctypes.c_longlong, ptr, ptr]
            fn.restype = i
        lib.vecmat_error_string.argtypes = [i]
        lib.vecmat_error_string.restype = ctypes.c_char_p
        lib._dns_typed = True
    return lib


def vecmat_ld(n, itemsize):
    """The leading dimension the kernel streams: ``n`` rounded up to whole
    16-byte vectors (a bulk copy needs 16-byte aligned rows)."""
    per = 16 // itemsize
    return -(-n // per) * per


def vecmat_operand(m, n, dtype=torch.float32, device=None):
    """Zeroed storage ``(m, vecmat_ld(n))`` for an operand of
    :func:`vecmat`; returns the ``(m, n)`` view the callers use (its rows
    are 16-byte aligned; the padding columns are never written)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return torch.zeros((m, vecmat_ld(n, itemsize)), dtype=dtype,
                       device=device)[:, :n]


def as_vecmat_operand(A, dtype=None, device=None):
    """``A`` (any 2-D layout) copied, cast and moved into
    :func:`vecmat_operand` storage in one pass (no second full copy)."""
    out = vecmat_operand(A.shape[0], A.shape[1], dtype or A.dtype,
                         A.device if device is None else device)
    return out.copy_(A)


class VecmatPlan(collections.namedtuple(
        "VecmatPlan", "blocks ld slabs box_rows box_cols stages smem_bytes")):
    """Launch plan of ``csrc/vecmat.cu`` for one operand shape: ``blocks``
    (one per SM), the leading dimension ``ld`` that :func:`vecmat_operand`
    allocates, the units (``slabs`` row slabs of ``box_rows`` x column
    tiles of ``box_cols``, one tensor copy each: unit ``u`` is slab ``u //
    tiles``, tile ``u % tiles``; the blocks take them from a counter and a
    unit's partial sums go to row ``slab`` of a ``(slabs, n)`` scratch), the
    ring of ``stages`` boxes and the block's shared memory.  Every field
    but ``ld`` is what a launch consumes: the box and the ring are compiled
    into the kernel from the same geometry, the scratch is ``(slabs, n)``,
    and the kernel refuses a shared-memory size other than its own."""


def vecmat_plan(m, n, sm_count, itemsize):
    """The :class:`VecmatPlan` of an ``(m, n)`` operand of ``itemsize``
    bytes on a card with ``sm_count`` SMs."""
    g = _VECMAT_GEOMETRY
    rows, stages = g["BOX_ROWS"], g["STAGES"]
    box_bytes = rows * g["GROUPS"] * 16
    # the ring, the row lanes' join (two 16-byte vectors a consumer), the
    # full and empty mbarriers and a header word per slot
    smem = stages * box_bytes + 2 * g["CONSUMERS"] * 16 + stages * (8 + 8 + 4)
    return VecmatPlan(sm_count, vecmat_ld(n, itemsize), -(-m // rows), rows,
                      g["GROUPS"] * 16 // itemsize, stages, smem)


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    # cached: the device query costs more host time than the launch itself
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _vecmat_plan_on(m, n, itemsize, device):
    return vecmat_plan(m, n, _sm_count(device), itemsize)


_SCRATCH = {}


_NO_SWITCH = contextlib.nullcontext()


def _on_device(index):
    """A kernel launches on the current device: switch to device ``index``
    only when it is another one (the switch costs more host time than the
    launch)."""
    if index == torch.cuda.current_device():
        return _NO_SWITCH
    return torch.cuda.device(index)


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _raw_stream(index):
    """The current CUDA stream of device ``index`` as an integer handle
    (without building a ``torch.cuda.Stream``: a few microseconds a call)."""
    if _RAW_STREAM is None:
        return torch.cuda.current_stream(index).cuda_stream
    return _RAW_STREAM(index)


def _stream_scratch(key, make):
    """Scratch that belongs to one stream (a kernel's partial sums, its
    ticket and grid-barrier words), keyed by the raw stream handle: made at
    a stream's first call, kept for later ones.  Made outside a CUDA-graph
    capture only, so that it is not a graph's private memory.

    A graph captured on a stream shares this scratch with eager calls on
    that stream and with every other graph captured on it, and a replay
    runs on whatever stream is current: such a graph must not run
    concurrently with them, or the ticket hand-out and the barrier counts
    break silently.  The port runs everything on one stream, in order.
    (The affine kernel, ``csrc/affine.cu``, keeps no scratch and no
    counter: its graphs carry no such caveat.)
    Entries are never released: a captured graph keeps raw pointers into
    them.  They number one per stream and operand shape."""
    got = _SCRATCH.get(key)
    if got is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "a kernel's scratch for this stream is made at its first "
                "call: call it once on the capture stream before capturing")
        got = _SCRATCH[key] = make()
    return got


def vecmat_ref(x, KT):
    """Plain PyTorch version of :func:`vecmat`: ``x (m,) @ KT (m, n)``."""
    return x @ KT


def _vecmat_check(x, KT):
    if x.dim() != 1 or KT.dim() != 2 or KT.shape[0] != x.shape[0]:
        raise ValueError(f"vecmat: x {tuple(x.shape)} @ KT {tuple(KT.shape)}")
    if x.dtype != KT.dtype or x.device != KT.device:
        raise ValueError(
            f"vecmat: x is {x.dtype} on {x.device}, "
            f"KT is {KT.dtype} on {KT.device}")


def _vecmat_launch(x, KT, trace=None):
    """Launch ``csrc/vecmat.cu`` on the current stream (``trace``: an int64
    tensor of 4 per block for the blocks' timestamps, or None).  Returns
    ``y``."""
    if KT.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"vecmat kernel takes f32 or f64, not {KT.dtype}")
    m, n = KT.shape
    ld, item = KT.stride(0), KT.element_size()
    if (KT.stride(1) != 1 or ld < n or (ld * item) % 16
            or KT.data_ptr() % 16):
        raise ValueError(
            f"vecmat kernel needs rows 16-byte aligned and unit column "
            f"stride, got strides {KT.stride()} of {KT.dtype}: allocate the "
            f"operand once with ops.kernels.vecmat_operand / "
            f"as_vecmat_operand (it is never copied here)")
    if m == 0 or n == 0 or m >= 2 ** 31 or ld >= 2 ** 31:
        raise ValueError(f"vecmat kernel: unsupported shape {(m, n)}")
    x = x.contiguous()
    lib = _vecmat_lib()
    fn = lib.vecmat_f32 if KT.dtype == torch.float32 else lib.vecmat_f64
    dev = KT.get_device()
    plan = _vecmat_plan_on(m, n, item, dev)
    stream = _raw_stream(dev)
    with _on_device(dev):
        part, bar = _stream_scratch(
            ("vecmat", dev, stream, plan.slabs, n, KT.dtype),
            lambda: (torch.empty((plan.slabs, n), dtype=KT.dtype,
                                 device=KT.device),
                     torch.zeros(4, dtype=torch.int32, device=KT.device)))
        y = torch.empty(n, dtype=KT.dtype, device=KT.device)
        err = fn(x.data_ptr(), KT.data_ptr(), y.data_ptr(), part.data_ptr(),
                 bar.data_ptr(), m, n, ld, plan.blocks, plan.smem_bytes,
                 None if trace is None else trace.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"vecmat kernel launch failed for shape {(m, n)}: "
            f"{lib.vecmat_error_string(err).decode()}")
    return y


def vecmat(x, KT):
    """``x (m,) @ KT (m, n) -> (n,)`` accumulated in the operands' type
    (f32 or f64), any ``m, n``; pass ``KT`` = the transposed matrix to
    compute ``K @ x``.

    On a CUDA tensor this launches the hand-written kernel of
    ``csrc/vecmat.cu`` on the current stream — one device kernel per call —
    and counts the launch in ``vecmat.launches``; ``KT``'s rows must be
    16-byte aligned with unit column stride (allocate it once with
    :func:`vecmat_operand` / :func:`as_vecmat_operand`; anything else
    raises, it is never copied).  The kernel's partial sums and counters
    belong to the stream of the call: a CUDA graph that captures it must not
    replay concurrently with other work on its capture stream (the port
    runs on one stream; see :func:`_stream_scratch`).  On a CPU tensor it
    is :func:`vecmat_ref`.
    """
    _vecmat_check(x, KT)
    if not x.is_cuda:
        return vecmat_ref(x, KT)
    y = _vecmat_launch(x, KT)
    vecmat.launches += 1
    return y


vecmat.launches = 0


# ---------------------------------------------------------------------------
# banded and static-window block matvecs of the block-Schur solver
# ---------------------------------------------------------------------------

def band_operand(shape, dtype=torch.float32, device=None):
    """Zeroed storage for a block operand of :func:`banded_mv`,
    :func:`rect_mv` or :func:`rect_mv_levels` (``(nblk, bs, w)`` or
    ``(nblk, L, bs, w)``): the last dimension padded to whole 16-byte
    vectors, so that every row, level and block starts 16-byte aligned.
    Returns the ``shape`` view (the padding is zero and never read)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    *lead, w = shape
    return torch.zeros((*lead, vecmat_ld(w, itemsize)), dtype=dtype,
                       device=device)[..., :w]


def as_band_operand(A, dtype=None, device=None):
    """``A`` copied, cast and moved into :func:`band_operand` storage."""
    A = torch.as_tensor(A)
    out = band_operand(tuple(A.shape), dtype or A.dtype,
                       A.device if device is None else device)
    return out.copy_(A)


def _windows(x, base, w):
    """``(nblk, w)``: ``x[base[k] + j]``, zero outside ``[0, len(x))``."""
    idx = base.to(device=x.device, dtype=torch.int64)[:, None] + \
        torch.arange(w, device=x.device)
    inside = (idx >= 0) & (idx < x.shape[0])
    return torch.where(inside, x[idx.clamp(0, max(x.shape[0] - 1, 0))],
                       x.new_zeros(()))


def _levels_ref(stack, base, x, nrows):
    """The plain product of the three forms: ``stack (nblk, L, bs, w)``;
    window gather, one einsum in the promoted type, level dots added in
    order, rows folded and cut at ``nrows``."""
    dt = torch.promote_types(stack.dtype, x.dtype)
    xw = _windows(x, base, stack.shape[-1]).to(dt)
    y2 = torch.einsum("klij,kj->lki", stack.to(dt), xw)
    y = y2[0]
    for lev in y2[1:]:
        y = y + lev
    return y.reshape(-1)[:nrows]


def banded_mv_ref(blocks, x):
    """Plain PyTorch version of :func:`banded_mv`."""
    nblk, bs = blocks.shape[:2]
    base = (torch.arange(nblk) - 1) * bs
    return _levels_ref(blocks[:, None], base, x, x.shape[0])


def rect_mv_ref(blocks, bases, x, nrows):
    """Plain PyTorch version of :func:`rect_mv`."""
    return _levels_ref(blocks[:, None], torch.as_tensor(bases), x, nrows)


def rect_mv_levels_ref(stack, bases, x, nrows, hi_only=False):
    """Plain PyTorch version of :func:`rect_mv_levels`."""
    if hi_only:
        stack = stack[:, :1]
    return _levels_ref(stack, torch.as_tensor(bases), x, nrows)


def pair_stack(blocks, parts=2):
    """Row-stacked bf16 levels of f32 blocks ``(nblk, bs, w)`` ->
    ``(nblk, parts, bs, w)`` in :func:`band_operand` storage on the blocks'
    device: level 0 is ``bf16(B)``, each next level the bf16 rounding of
    what the levels before leave (the last takes the whole remainder), so
    that their f32 sum is ``B`` to ~8 more bits a level.  (The JAX
    package's ``_pair_stack`` fences each rounding against XLA's
    excess-precision folding; eager torch rounds where it is told.)"""
    B = blocks.to(torch.float32)
    out = band_operand((B.shape[0], parts, *B.shape[1:]), torch.bfloat16,
                       B.device)
    rem = B
    for p in range(parts - 1):
        lev = rem.to(torch.bfloat16)
        out[:, p] = lev
        rem = rem - lev.to(torch.float32)
    out[:, parts - 1] = rem.to(torch.bfloat16)
    return out


def _bandmv_lib():
    lib = _load("bandmv")
    if not getattr(lib, "_dns_typed", False):
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bandmv_f32x.argtypes = ([ptr, i, i, ll, ll, ll, ptr, ptr, ptr]
                                    + [i] * 4 + [ll, ptr])
        lib.bandmv_f32x.restype = i
        lib.bandmv_ring_f32.argtypes = ([ptr, ll, ll, ptr, ptr, ptr]
                                        + [i] * 4 + [ll] + [i] * 3
                                        + [ll, ptr])
        lib.bandmv_ring_f32.restype = i
        lib.bandmv_stack.argtypes = ([ptr, i, i, ll, ll, ll, ptr, ptr, ptr]
                                     + [i] * 4 + [ll] + [i] * 4 + [ll, ptr])
        lib.bandmv_stack.restype = i
        lib.bandmv_error_string.argtypes = [i]
        lib.bandmv_error_string.restype = ctypes.c_char_p
        lib._dns_typed = True
    return lib


_BAND_STORAGE = {torch.float32: 0, torch.bfloat16: 1}


class BandmvPlan(collections.namedtuple(
        "BandmvPlan", "kernel blocks unit_rows stages slot_bytes smem_bytes")):
    """Launch plan of ``csrc/bandmv.cu`` for one operand shape: ``kernel``,
    ``"ring"``, ``"rows"`` (the warp-per-row kernel, whose grid ``blocks``
    is ``nblk * ceil(bs / ROWS)``; it needs nothing more) or ``"share"``
    (level stacks: :func:`stack_plan`); for the ring kernel ``blocks`` (the
    grid), ``unit_rows`` (unit
    ``u`` is the rows ``[i, i + unit_rows)`` of row block ``k = u // upb``,
    ``i = (u % upb) unit_rows``, ``upb = ceil(bs / unit_rows)``, cut at
    ``bs`` and at ``nrows``: one bulk copy a level of ``((rows - 1) ld + v
    ceil(w / v)) itemsize`` bytes, ``v = 16 / itemsize``; block ``b`` takes the units ``[b U // G + min(b, U
    % G), ...)``, ``U // G`` of them and one more for ``b < U % G``), the
    ring of ``stages`` slots of ``slot_bytes``, and the block's shared
    memory (per slot: two mbarriers, a header, the f32 x window of ``w``
    rounded up to whole 16-byte vectors, the rows of every level).  The
    kernel refuses a
    shared-memory size other than its own layout for these numbers."""


def _ring_smem(w, ld, itemsize, unit_rows, stages, levels=1):
    vec = 16 // itemsize
    return stages * (32 + 4 * vec * -(-w // vec)
                     + levels * unit_rows * ld * itemsize)


def _ring_launch(nblk, bs, w, ld, itemsize, sm_count, levels=1):
    """The ring kernel's :class:`BandmvPlan` for ``levels`` row-stacked
    levels (a unit's rows of every level in one slot, one bulk copy a
    level), or None where one row of every level beside its window does
    not fit a block's shared memory."""
    g = _BANDMV_PLAN
    rows, row_bytes = nblk * bs, levels * ld * itemsize
    blocks = min(g["BLOCKS_PER_SM"] * sm_count, rows)
    per_block = -(-rows // blocks)
    unit_rows = max(1, min(g["UNIT_BYTES"] // row_bytes,
                           -(-per_block // g["MIN_UNITS"])))
    while unit_rows > 1 and _ring_smem(w, ld, itemsize, unit_rows, 1,
                                       levels) > _SMEM_PER_BLOCK:
        unit_rows -= 1
    # a block's most units: its share of the units of all row blocks
    most = -(-(nblk * -(-bs // unit_rows)) // blocks)
    slot = unit_rows * row_bytes
    stages = max(1, min(g["RING_BYTES"] // slot, most))
    while stages > 1 and _ring_smem(w, ld, itemsize, unit_rows, stages,
                                    levels) > _SMEM_PER_BLOCK:
        stages -= 1
    smem = _ring_smem(w, ld, itemsize, unit_rows, stages, levels)
    if smem > _SMEM_PER_BLOCK:
        return None
    return BandmvPlan("ring", blocks, unit_rows, stages, slot, smem)


def _check_plan_args(nblk, bs, w, ld, itemsize, sm_count):
    if min(nblk, bs, w, sm_count) <= 0 or ld < w or (ld * itemsize) % 16:
        raise ValueError(f"bandmv_plan: no plan for ({nblk}, {bs}, {w}) "
                         f"rows {ld} x {itemsize} bytes apart")


def bandmv_plan(nblk, bs, w, ld, itemsize, sm_count):
    """The :class:`BandmvPlan` of a single-level ``(nblk, bs, w)`` operand
    with rows ``ld`` elements of ``itemsize`` bytes apart, on a card with
    ``sm_count`` SMs.  The ring kernel where the warp-per-row kernel's grid
    has fewer than ``RING_GRID_BELOW`` blocks an SM (on an H100 the
    warp-per-row kernel was as fast or faster wherever its grid filled the
    card; ``PERF.md``): ``BLOCKS_PER_SM`` blocks an SM, units of about
    ``UNIT_BYTES``, fewer rows where a block would otherwise get fewer than
    ``MIN_UNITS`` of them, so that a small operand spreads over every SM
    with copies in flight; as many slots as ``RING_BYTES`` holds and a
    block can use.  The warp-per-row kernel also where the ring cannot
    hold one row beside its window in a block's 227 KB; ``ValueError``
    where neither kernel can place the rows."""
    _check_plan_args(nblk, bs, w, ld, itemsize, sm_count)
    row_grid = nblk * -(-bs // _BANDMV_GEOMETRY["ROWS"])
    rows_plan = BandmvPlan("rows", row_grid, 0, 0, 0, 0)
    # the warp-per-row kernel's block holds its x window (w rounded up to
    # 8) in shared memory
    rows_fit = _window_bytes(w) <= _SMEM_PER_BLOCK
    if row_grid >= _BANDMV_PLAN["RING_GRID_BELOW"] * sm_count and rows_fit:
        return rows_plan
    ring = _ring_launch(nblk, bs, w, ld, itemsize, sm_count)
    if ring is not None:
        return ring
    if rows_fit:
        return rows_plan
    raise ValueError(
        f"bandmv_plan: rows of {ld * itemsize} bytes (w {w}) fit neither "
        f"kernel in {_SMEM_PER_BLOCK} bytes of shared memory a block")


def _window_bytes(w):
    """Shared memory of the warp-per-row and share kernels' f32 window."""
    return 4 * (-(-w // 8) * 8)


def stack_plan(nblk, levels, bs, w, ld, itemsize, sm_count, form=None):
    """The :class:`BandmvPlan` of a level stack ``(nblk, levels, bs, w)``
    of :func:`rect_mv_levels` (rows ``ld`` elements of ``itemsize`` bytes
    apart) on a card with ``sm_count`` SMs: ``kernel`` ``"rows"`` (the
    warp-per-row kernel on its grid ``nblk * ceil(bs / ROWS)``),
    ``"share"`` (the rows cut into ``blocks`` equal contiguous shares, a
    block staging each window of its share once; ``smem_bytes`` the
    window) or ``"ring"`` (the bulk-copy ring of :func:`bandmv_plan`, a
    unit's rows of every level in one slot).  ``form`` (or ``FORM`` of
    ``_STACK_PLAN``) forces one of them; ``ValueError`` where it cannot
    place the rows.  Otherwise as ``_STACK_PLAN`` says (measured on an
    H100: ``PERF.md``, section 6)."""
    _check_plan_args(nblk, bs, w, ld, itemsize, sm_count)
    if not 1 <= levels <= 3:
        raise ValueError(f"stack_plan: {levels} levels")
    g = _STACK_PLAN
    form = form or g["FORM"]
    rows = nblk * bs
    row_grid = nblk * -(-bs // _BANDMV_GEOMETRY["ROWS"])
    window = _window_bytes(w)
    blocks = min(g["SHARE_BLOCKS_PER_SM"] * sm_count, rows)
    if form is None:
        form = "rows"
        if nblk == 1:
            form = "share"
        elif levels >= g["SHARE_LEVELS"]:
            if window >= g["SHARE_WINDOW_BYTES"]:
                form, blocks = "share", -(-rows // g["SHARE_ROWS"])
            elif row_grid < g["RING_GRID_BELOW"] * sm_count:
                form = "ring"
    if form == "ring":
        plan = _ring_launch(nblk, bs, w, ld, itemsize, sm_count, levels)
    elif form not in ("rows", "share"):
        raise ValueError(f"stack_plan: no kernel form {form!r}")
    elif window > _SMEM_PER_BLOCK:
        plan = None
    elif form == "rows":
        plan = BandmvPlan("rows", row_grid, 0, 0, 0, window)
    else:
        plan = BandmvPlan("share", blocks, 0, 0, 0, window)
    if plan is None:
        raise ValueError(
            f"stack_plan: {levels} levels of rows of {ld * itemsize} bytes "
            f"(w {w}) do not fit the {form} kernel in {_SMEM_PER_BLOCK} "
            f"bytes of shared memory a block")
    return plan


@functools.lru_cache(maxsize=None)
def _stack_plan_on(nblk, levels, bs, w, ld, itemsize, device, form):
    return stack_plan(nblk, levels, bs, w, ld, itemsize, _sm_count(device),
                      form)


@functools.lru_cache(maxsize=None)
def _bandmv_plan_on(nblk, bs, w, ld, device):
    return bandmv_plan(nblk, bs, w, ld, 4, _sm_count(device))


def _bandmv_launch(name, stack, bases, x, nrows):
    """Launch ``csrc/bandmv.cu`` on ``stack (nblk, L, bs, w)`` (``bases``:
    int32 window starts on the device, or None for the banded form) on the
    current stream; returns ``(y (nrows,) f32, the kernel form)``.

    The kernels are bound by bytes: each stored entry is read once for one
    multiply-add.  :func:`banded_mv` and :func:`rect_mv` on f32 blocks run
    on the kernel :func:`bandmv_plan` picks (the bulk-copy ring where the
    warp-per-row kernel's grid would not fill the card), bf16 blocks on the
    warp-per-row kernel.  :func:`rect_mv_levels` runs on the form
    :func:`stack_plan` picks for the stack's shape: the share kernel for
    the one row block of ``S^-1`` (64 warp-per-row blocks at level 1, each
    restaging all of x; two blocks an SM stage it once each) and for W's
    three levels under a window of 16 KB or more; the ring for W's three
    levels where the warp-per-row grid runs a wave and a bit (level 1); the
    warp-per-row kernel elsewhere."""
    if stack.dtype not in _BAND_STORAGE or x.dtype != torch.float32:
        raise TypeError(
            f"{name} kernel takes f32 or bf16 blocks under an f32 vector, "
            f"not {stack.dtype} blocks under {x.dtype}")
    if x.device != stack.device:
        raise ValueError(f"{name}: x is on {x.device}, the blocks on "
                         f"{stack.device}")
    nblk, levels, bs, w = stack.shape
    item = stack.element_size()
    sblk, slev, ld, unit = stack.stride()
    if (unit != 1 or ld < w or stack.data_ptr() % 16
            or any((s * item) % 16 for s in (sblk, slev, ld))):
        raise ValueError(
            f"{name} kernel needs 16-byte aligned rows, levels and blocks "
            f"with unit column stride, got strides {stack.stride()} of "
            f"{stack.dtype}: allocate the operand once with "
            f"ops.kernels.band_operand / as_band_operand (it is never copied "
            f"here)")
    if not 1 <= levels <= 3 or nblk * bs < nrows or nrows <= 0:
        raise ValueError(f"{name} kernel: {levels} levels of {nblk} blocks "
                         f"of {bs} rows for {nrows} output rows")
    dev = stack.get_device()
    if name == "rect_mv_levels":
        plan = _stack_plan_on(nblk, levels, bs, w, ld, item, dev,
                              _STACK_PLAN["FORM"])
    elif stack.dtype == torch.float32:
        plan = _bandmv_plan_on(nblk, bs, w, ld, dev)
    else:
        plan = BandmvPlan("rows", 0, 0, 0, 0, 0)
    if bases is not None and (
            bases.dtype != torch.int32 or bases.device != stack.device
            or bases.shape != (nblk,) or not bases.is_contiguous()):
        raise ValueError(f"{name} kernel: bases must be {nblk} contiguous "
                         f"int32 on {stack.device}, got {bases.dtype} "
                         f"{tuple(bases.shape)} on {bases.device}")
    x = x.contiguous()
    lib = _bandmv_lib()
    y = torch.empty(nrows, dtype=torch.float32, device=stack.device)
    bp = None if bases is None else bases.data_ptr()
    slev = slev if levels > 1 else 0
    with _on_device(dev):
        if name == "rect_mv_levels" and plan.kernel != "rows":
            err = lib.bandmv_stack(
                stack.data_ptr(), _BAND_STORAGE[stack.dtype], levels, sblk,
                slev, ld, bp, x.data_ptr(), y.data_ptr(), nblk, bs, w,
                x.shape[0], nrows, _STACK_FORMS[plan.kernel], plan.blocks,
                plan.unit_rows, plan.stages, plan.smem_bytes,
                _raw_stream(dev))
        elif plan.kernel == "ring":
            err = lib.bandmv_ring_f32(
                stack.data_ptr(), sblk, ld, bp, x.data_ptr(), y.data_ptr(),
                nblk, bs, w, x.shape[0], nrows, plan.blocks, plan.unit_rows,
                plan.stages, plan.smem_bytes, _raw_stream(dev))
        else:
            err = lib.bandmv_f32x(
                stack.data_ptr(), _BAND_STORAGE[stack.dtype], levels, sblk,
                slev, ld, bp, x.data_ptr(), y.data_ptr(), nblk, bs, w,
                x.shape[0], nrows, _raw_stream(dev))
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed ({levels} x {tuple(stack.shape)} "
            f"{stack.dtype}, {plan.kernel} kernel): "
            f"{lib.bandmv_error_string(err).decode()}")
    return y, plan.kernel


_STACK_FORMS = {"share": 1, "ring": 2}


def _count(wrapper, kernel):
    wrapper.launches += 1
    wrapper.kernel_launches[kernel] += 1


def banded_mv(blocks, x):
    """Block-tridiagonal matvec ``y (n,) = F_perm @ x`` from the banded
    blocks ``(nblk, bs, 3 bs)`` of :func:`..solve.sadpnt._build_banded`:
    ``y[k bs + i] = sum_j B[k, i, j] x[(k-1) bs + j]`` with ``x`` read as
    zero outside ``[0, n)`` (``n = len(x)``, no padding).  The JAX
    package's ``_banded_mv``.

    On a CUDA tensor this launches the hand-written kernel of
    ``csrc/bandmv.cu`` (f32 blocks under an f32 ``x``, 16-byte aligned
    rows: :func:`band_operand`; anything else raises) and counts it in
    ``banded_mv.launches`` (and by kernel form in ``kernel_launches``); on
    a CPU tensor it is :func:`banded_mv_ref`
    (an einsum in the promoted type: f32 blocks under f64 work stay f32
    entries in f64 arithmetic)."""
    nblk, bs, w3 = blocks.shape
    if w3 != 3 * bs or x.dim() != 1 or nblk * bs < x.shape[0]:
        raise ValueError(f"banded_mv: blocks {tuple(blocks.shape)} @ x "
                         f"{tuple(x.shape)}")
    if not x.is_cuda:
        return banded_mv_ref(blocks, x)
    y, kernel = _bandmv_launch("banded_mv", blocks[:, None], None, x,
                               x.shape[0])
    _count(banded_mv, kernel)
    return y


banded_mv.launches = 0
banded_mv.kernel_launches = dict(rows=0, ring=0)


def rect_mv(blocks, bases, x, nrows):
    """Static-window rectangular matvec ``y (nrows,)`` with ``y[k bs + i] =
    sum_j B[k, i, j] x[bases[k] + j]``, ``blocks (nblk, bs, w)``, ``x``
    read as zero past its length (the JAX package's ``_rect_mv``, whose
    callers zero-pad ``x``).  ``bases``: one window start per block — an
    int32 tensor on the blocks' device for the kernel.

    On a CUDA tensor this launches ``csrc/bandmv.cu`` (f32 blocks, f32
    ``x``, :func:`band_operand` storage) and counts it in
    ``rect_mv.launches`` (and by kernel form in ``kernel_launches``); on a
    CPU tensor it is :func:`rect_mv_ref`."""
    if blocks.dim() != 3 or x.dim() != 1:
        raise ValueError(f"rect_mv: blocks {tuple(blocks.shape)} @ x "
                         f"{tuple(x.shape)}")
    if not x.is_cuda:
        return rect_mv_ref(blocks, bases, x, nrows)
    y, kernel = _bandmv_launch("rect_mv", blocks[:, None], bases, x, nrows)
    _count(rect_mv, kernel)
    return y


rect_mv.launches = 0
rect_mv.kernel_launches = dict(rows=0, ring=0)


def rect_mv_levels(stack, bases, x, nrows, hi_only=False):
    """:func:`rect_mv` over ``L`` row-stacked levels ``stack (nblk, L, bs,
    w)`` (bf16 levels of :func:`pair_stack`, or f32 ones): the ``L`` row
    dots added in level order, f32 accumulation; ``hi_only`` reads level 0
    alone.  The JAX package's ``_rect_mv_pair`` and, with one block of the
    whole ``S^-1`` stack (base 0), ``SchurSaddleSolver._sapply``.

    On a CUDA tensor this launches ``csrc/bandmv.cu`` (one to three f32 or
    bf16 levels under an f32 ``x``, :func:`band_operand` storage) on the
    kernel form :func:`stack_plan` picks, and counts it in
    ``rect_mv_levels.launches`` (and by form in ``kernel_launches``, by the
    launched stack's shape in ``stack_launches``); on a CPU tensor it is
    :func:`rect_mv_levels_ref`."""
    if stack.dim() != 4 or x.dim() != 1:
        raise ValueError(f"rect_mv_levels: stack {tuple(stack.shape)} @ x "
                         f"{tuple(x.shape)}")
    if not x.is_cuda:
        return rect_mv_levels_ref(stack, bases, x, nrows, hi_only)
    stack = stack[:, :1] if hi_only else stack
    y, kernel = _bandmv_launch("rect_mv_levels", stack, bases, x, nrows)
    _count(rect_mv_levels, kernel)
    shape = tuple(stack.shape)
    rect_mv_levels.stack_launches[shape] = \
        rect_mv_levels.stack_launches.get(shape, 0) + 1
    return y


rect_mv_levels.launches = 0
rect_mv_levels.kernel_launches = dict(rows=0, ring=0, share=0)
# launches by the shape of the stack launched ((nblk, L, bs, w); hi_only
# launches level 0 alone)
rect_mv_levels.stack_launches = {}


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


def ell_slot_table(rowptr, slots):
    """The CSR table of :func:`dof_slot_table` as a dof-major padded (ELL)
    table ``ell (width, nseg)`` int32: ``ell[k, i]`` is segment ``i``'s
    ``k``-th slot in the same ascending order, ``-1`` past its count;
    ``width`` is the largest count (at least 1)."""
    rowptr, slots = np.asarray(rowptr), np.asarray(slots)
    cnt = np.diff(rowptr)
    nseg = len(cnt)
    ell = np.full((max(1, int(cnt.max(initial=0))), nseg), -1, np.int32)
    seg = np.repeat(np.arange(nseg), cnt)
    ell[np.arange(len(slots)) - rowptr[:-1][seg], seg] = slots
    return ell


def reduce_ell_ref(vals, ell):
    """Plain PyTorch version of the kernel's reduction over an ELL table:
    ``out[i]`` adds ``vals[ell[k, i]]`` for ``k`` ascending, skipping
    ``-1``."""
    ell = ell.long()
    out = torch.zeros(ell.shape[1], dtype=vals.dtype, device=vals.device)
    for k in range(ell.shape[0]):
        m = ell[k] >= 0
        out[m] += vals[ell[k][m]]
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
    its int32 copy and the dof -> scratch-slot ELL table of the fixed-order
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

    def slot_table(self):
        """``(rowptr, slots)``, the CSR table of :func:`dof_slot_table`
        (numpy): for each dof its flat scratch positions ``r*nd + j``,
        ascending."""
        return dof_slot_table(self.vd.cpu().numpy(), self.nseg)

    def kernel_tables(self):
        """``(vd32 (n, nd), ell (width, nseg))`` int32 on the device: the
        ids, and :func:`ell_slot_table` of :meth:`slot_table`."""
        if self._kernel_tables is None:
            vd = self.vd.cpu().numpy()
            ell = ell_slot_table(*dof_slot_table(vd, self.nseg))
            self._kernel_tables = tuple(
                torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                                device=self.vd.device)
                for a in (vd, ell))
        return self._kernel_tables


class _ConvPlanC(ctypes.Structure):
    # csrc/convection.cu: ConvPlan, field for field
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "vd", "JinvT", "wdet", "N2", "dN2", "fac_elem", "fac_vd", "ell",
        "fell", "scratch", "bar", "trace")]
        + [(f, ctypes.c_int) for f in (
            "nc", "nv_full", "nfac", "width", "fwidth", "work_f64", "u_f64",
            "fused")])


class ConvPlan:
    """Launch plan of ``csrc/convection.cu`` for one table set, one form
    (``fused``), one state type, one set of facet blocks and one stream:
    every constant pointer and size in one C structure (``c``), the tensors
    behind them, and the kernel's scratch and barrier counter.  The scratch
    belongs to the plan's stream; :meth:`ConvTables.kernel_plan` makes one
    per stream, and the port runs on one.  A CUDA graph captured on that
    stream shares the scratch and the counter with eager calls there: it
    must not replay concurrently with them."""

    def __init__(self, t, fused, udtype, fac_elem, fac_vdofs, stream):
        dev = t.device
        nfac = 0 if fac_elem is None else int(fac_elem.shape[0])
        vd32, ell = t.kernel_tables()
        # what the pointers point into, and the objects the key names
        self.keep = [vd32, ell, fac_elem, fac_vdofs]
        fe = fv = fell = None
        if nfac:
            fe = fac_elem.to(device=dev, dtype=t.dtype).contiguous()
            fv, fell = fac_vdofs.kernel_tables()
            self.keep += [fe, fv, fell]
        self.scratch = torch.empty(
            (1 + fused) * t.nc * t.nd + nfac * t.nd, dtype=t.dtype,
            device=dev)
        self.bar = torch.zeros(2, dtype=torch.int32, device=dev)
        self.stream = stream
        self.nout = 2 if fused else 1
        self.fn = None              # the C entry point, bound at first launch

        def ptr(x):
            return None if x is None else x.data_ptr()

        self.c = _ConvPlanC(
            ptr(vd32), ptr(t.JinvT), ptr(t.wdet), ptr(t.N2), ptr(t.dN2),
            ptr(fe), ptr(fv), ptr(ell), ptr(fell), ptr(self.scratch),
            ptr(self.bar), None, t.nc, t.nv_full, nfac, ell.shape[0],
            0 if fell is None else fell.shape[0],
            int(t.dtype == torch.float64), int(udtype == torch.float64),
            int(bool(fused)))


def _plan_key(fused, udtype, stream, fac_elem, fac_vdofs):
    # the plan keeps both objects, so their ids stay theirs
    return (bool(fused), udtype, stream, id(fac_elem), id(fac_vdofs))


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
        self.device_index = self.wdet.get_device()      # -1: the CPU
        self._plain = None
        self._plans = {}

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
                               if k not in ("dofs", "_plain", "_plans")},
                            "vd": vd})
        new._plain = self._plain
        return new

    def kernel_tables(self):
        """The element table's :meth:`DofTable.kernel_tables`."""
        return self.dofs.kernel_tables()

    def kernel_plan(self, fused, udtype, fac_elem=None, fac_vdofs=None,
                    stream=0):
        """The :class:`ConvPlan` of this table set for one form, state type,
        facet-block set and stream: made at its first call, kept after."""
        key = _plan_key(fused, udtype, stream, fac_elem, fac_vdofs)
        plan = self._plans.get(key)
        if plan is None:
            if (self.device_index >= 0
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError(
                    "the convection kernel's plan for this stream is made at "
                    "its first call: call it once on the capture stream "
                    "before capturing")
            nfac = 0 if fac_elem is None else int(fac_elem.shape[0])
            plan = self._plans[key] = ConvPlan(
                self, fused, udtype, fac_elem if nfac else None,
                fac_vdofs, stream)
            plan.keep += [fac_elem]
        return plan

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
            [ctypes.POINTER(_ConvPlanC)] + [ptr] * 4
            + [ctypes.c_double, i, ptr])
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
    if u.get_device() != t.device_index:
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
                 fac_vdofs=None):
    """Launch ``csrc/convection.cu`` on the current stream through the
    tables' plan; returns the ``(1 + fused, nv_full)`` output in ``u1``'s
    type.  The checks that depend only on the plan's key run when the plan
    is made."""
    dev = u1.get_device()
    stream = _raw_stream(dev)
    plan = t._plans.get(_plan_key(fused, u1.dtype, stream, fac_elem,
                                  fac_vdofs))
    if plan is None:
        ok = (torch.float32, torch.float64)
        if t.dtype not in ok or u1.dtype not in ok:
            raise TypeError(f"{name} kernel takes f32 or f64, not tables "
                            f"{t.dtype} / state {u1.dtype}")
        if (t.nvpc, t.Q, t.dim) != (6, 7, 2):
            raise NotImplementedError(
                f"{name} kernel: only the 2D Taylor-Hood instantiation (nvpc "
                f"6, Q 7, dim 2) is built, not {(t.nvpc, t.Q, t.dim)}")
        if fused:
            _check_facets(name, t, fac_elem, fac_vdofs)
        plan = t.kernel_plan(fused, u1.dtype, fac_elem, fac_vdofs, stream)
    if plan.fn is None:
        plan.fn = _conv_lib().convection_th2d
    u1 = u1.contiguous()
    if u2 is not None:
        u2 = u2.contiguous()
    out = torch.empty((plan.nout, t.nv_full), dtype=u1.dtype,
                      device=u1.device)
    p0 = out.data_ptr()
    with _on_device(dev):
        err = plan.fn(
            plan.c, u1.data_ptr(), None if u2 is None else u2.data_ptr(),
            p0, p0 + (plan.nout - 1) * t.nv_full * out.element_size(),
            float(nu), int(bool(sym)), stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed (nc {t.nc}, nv_full {t.nv_full}, "
            f"{plan.c.nfac} facet blocks): "
            f"{_conv_lib().convection_error_string(err).decode()}")
    return out


def conv_vector(u1, u2, tables):
    """The convection vector ``int ((u2 . grad) u1) . phi dx`` over the
    full velocity dofs; ``u2=None`` means ``u2 = u1``.  Arithmetic in
    ``tables.dtype``, result in ``u1``'s type.

    On a CUDA tensor this launches the hand-written kernel of
    ``csrc/convection.cu`` (element phase, grid barrier, fixed-order
    reduction: one device kernel) on the current stream, through the
    tables' :class:`ConvPlan` for that stream, and counts it in
    ``conv_vector.launches``; on a CPU tensor it is :func:`conv_vector_ref`.
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
    (one device kernel, through the tables' :class:`ConvPlan` for the
    current stream: the port runs on one) and counts it in
    ``conv_vector_amatvec.launches``; on a CPU tensor it is
    :func:`conv_vector_amatvec_ref`.
    """
    name = "conv_vector_amatvec"
    _check_state(name, u, tables)
    if not u.is_cuda:
        _check_facets(name, tables, fac_elem, fac_vdofs)
        return conv_vector_amatvec_ref(u, nu, sym, tables, fac_elem,
                                       fac_vdofs)
    out = _conv_launch(name, tables, u, None, fused=True, nu=nu, sym=sym,
                       fac_elem=fac_elem, fac_vdofs=fac_vdofs)
    conv_vector_amatvec.launches += 1
    return out[0], out[1]


conv_vector_amatvec.launches = 0


# ---------------------------------------------------------------------------
# the affine element matvecs (M, A, cm M + ca A, J, J^T) and the saddle
# residual
# ---------------------------------------------------------------------------

# the kernel's mode argument per matvec kind ('m' and 'a' are the fused
# form with cm, ca = 1, 0 and 0, 1; 'res' the saddle residual)
_AFFINE_MODES = {"m": 0, "a": 0, "ma": 0, "j": 1, "jt": 2}
_AFFINE_RES = 3
# How affine_plan cuts the elements, in their locality order, into chunks:
# sized so that the grid has about BLOCKS_PER_SM blocks an SM (the fastest
# chunk in the measured sweep at levels 1 and 2), at least MIN_CHUNK
# elements.  A partition whose largest block would take more shared memory
# than _AFFINE_SMEM (what a launch takes without opting in) is made anew
# on chunks half as large, until it fits.
_AFFINE_PLAN = {"BLOCKS_PER_SM": 2, "MIN_CHUNK": 4}
_AFFINE_SMEM = 48 * 1024


def affine_plan(mode, nc, sm_count):
    """The chunk (elements a block's chunk takes in the locality order) of
    ``mode`` (a key of ``_AFFINE_MODES`` or ``'res'``) on ``nc`` elements
    on a card with ``sm_count`` SMs."""
    if mode not in _AFFINE_MODES and mode != "res":
        raise ValueError(f"affine_mv mode {mode!r}")
    cfg = _AFFINE_PLAN
    return int(max(cfg["MIN_CHUNK"],
                   -(-nc // (cfg["BLOCKS_PER_SM"] * sm_count))))


def element_locality_order(ids, nseg):
    """The elements of ``ids (nc, ns)`` in a locality order: reverse
    Cuthill-McKee over the graph of elements that share an output id in
    ``[0, nseg)``."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    ids = np.asarray(ids)
    nc, ns = ids.shape
    el = np.repeat(np.arange(nc), ns)
    flat = ids.ravel()
    keep = (flat >= 0) & (flat < nseg)
    e2d = sps.csr_matrix((np.ones(int(keep.sum())), (el[keep], flat[keep])),
                         shape=(nc, nseg))
    return reverse_cuthill_mckee((e2d @ e2d.T).tocsr(),
                                 symmetric_mode=True).astype(np.int64)


def affine_partition(ids, nseg, chunk, fac_ids=None, pids=None, npseg=0,
                     max_own=256):
    """The kernel's partition of the output ids ``ids (nc, ns)`` over
    ``nseg`` dofs (numpy): elements in their :func:`element_locality_order`
    are cut into chunks of ``chunk``; a dof belongs to the block of its
    first element in that order (a dof of no element to block 0), and the
    block computes every element its dofs touch and, with ``fac_ids
    (nfac, ns)`` (facet blocks whose row ``r = f * ns + a`` adds into dof
    ``fac_ids[f, a]``), its dofs' facet rows.  With ``pids (nc, ps)`` over
    ``npseg`` pressure dofs (the residual's joint partition) the pressure
    dofs are owned alike, numbered ``nseg + p``, and a block's elements
    are those of both kinds of its dofs.  A block that would own more than
    ``max_own`` dofs (the kernel's threads: one a dof) is split, its dofs
    in ascending order.

    Returns a dict: ``eptr (nblk+1)`` into ``elem``, each block's elements
    ascending; ``fptr (nblk+1)`` into ``frow``, its facet rows ascending;
    ``optr (nblk+1)`` into ``own``, its dofs ascending (every dof once);
    ``lell (width, nseg + npseg)``: column ``k`` the slots of ``own[k]`` as
    positions in its block's values — facet row ``frow[fptr[b] + f]`` at
    ``f``, element slot ``(elem[eptr[b] + l], j)`` at ``nf + l * ns + j``
    (``nf``, ``ne`` the block's facet rows and elements), a pressure slot
    at ``nf + 2 * ne * ns + l * ps + j`` (past the two velocity value sets
    of the residual) — its element slots in the ascending order of
    :func:`dof_slot_table`, then its facet rows ascending, ``-1`` past its
    count; ``cnt (nblk, 4)``: elements, facet rows, ``optr[b]``, dofs;
    ``emax``, ``fmax``, the most elements and facet rows of a block;
    ``nblk``."""
    ids = np.asarray(ids)
    nc, ns = ids.shape
    kinds = [(ids, nseg, ns, 0)]
    if pids is not None:
        pids = np.asarray(pids)
        kinds.append((pids, npseg, pids.shape[1], nseg))
    ntot = nseg + (npseg if pids is not None else 0)
    # every (dof, slot) pair of both kinds, dofs numbered into [0, ntot)
    dof, el, jj, rank, kind = [], [], [], [], []
    for k, (kid, n, width, base) in enumerate(kinds):
        rowptr, slots = dof_slot_table(kid, n)
        d = np.repeat(np.arange(n), np.diff(rowptr))
        dof.append(d + base)
        el.append(slots.astype(np.int64) // width)
        jj.append(slots.astype(np.int64) % width)
        rank.append(np.arange(len(slots)) - rowptr[:-1][d])
        kind.append(np.full(len(slots), k))
    dof, el, jj, rank, kind = map(np.concatenate, (dof, el, jj, rank, kind))
    cnt = np.bincount(dof, minlength=ntot)
    pos = np.empty(nc, np.int64)
    pos[element_locality_order(ids, nseg)] = np.arange(nc)
    first = np.full(ntot, nc, np.int64)
    np.minimum.at(first, dof, pos[el])
    block = np.where(cnt > 0, first // chunk, 0)
    # each block's dofs ascending, max_own a block (split where more)
    by = np.lexsort((np.arange(ntot), block))
    start = np.searchsorted(block[by], block[by])
    sub = np.empty(ntot, np.int64)
    sub[by] = (np.arange(ntot) - start) // max_own
    _, block = np.unique(block * ntot + sub, return_inverse=True)
    block = block.ravel()                               # no empty block
    nblk = int(block.max()) + 1

    def ptr(of):
        return np.concatenate([[0], np.cumsum(np.bincount(
            of, minlength=nblk))]).astype(np.int64)

    own = np.lexsort((np.arange(ntot), block))
    optr = ptr(block)
    key = block[dof] * nc + el
    ukey = np.unique(key)
    eptr = ptr(ukey // nc)
    ne = np.diff(eptr)
    # the facet rows, by the block of their dof
    if fac_ids is None:
        fac_ids = np.zeros((0, ns), np.int64)
    frp, fsl = dof_slot_table(fac_ids, nseg)
    fcnt = np.diff(frp)
    fdof = np.repeat(np.arange(nseg), fcnt)
    fkey = block[fdof] * max(1, fac_ids.size) + fsl
    order = np.argsort(fkey, kind="stable")
    fptr = ptr(block[fdof])
    frow = fsl[order]
    flocal = np.empty(len(fsl), np.int64)
    flocal[order] = np.arange(len(fsl)) - fptr[block[fdof[order]]]
    nf = np.diff(fptr)
    b = block[dof]
    l = np.searchsorted(ukey, key) - eptr[b]
    width = np.array([k[2] for k in kinds])[kind]
    local = nf[b] + np.where(kind == 0, 0, 2 * ne[b] * ns) + l * width + jj
    kpos = np.empty(ntot, np.int64)
    kpos[own] = np.arange(ntot)
    fall = np.zeros(ntot, np.int64)
    fall[:nseg] = fcnt
    lell = np.full((max(1, int((cnt + fall).max(initial=0))), ntot), -1,
                   np.int32)
    lell[rank, kpos[dof]] = local
    lell[cnt[fdof] + np.arange(len(fsl)) - frp[:-1][fdof],
         kpos[fdof]] = flocal
    i32 = functools.partial(np.ascontiguousarray, dtype=np.int32)
    return dict(eptr=i32(eptr), elem=i32(ukey % nc), fptr=i32(fptr),
                frow=i32(frow), optr=i32(optr), own=i32(own), lell=lell,
                cnt=i32(np.stack([ne, nf, optr[:-1], np.diff(optr)], 1)),
                emax=int(ne.max()), fmax=int(nf.max()), nblk=nblk)


def affine_fit(t, kind, chunk, smem_max=None):
    """``(part, chunk, smem)``: :func:`affine_partition` of the tables
    ``t`` for ``kind`` ``'v'`` (velocity dofs and facet rows), ``'p'``
    (pressure dofs) or ``'res'`` (both), over chunks of ``chunk`` elements,
    halved until its largest block's values (in the tables' type) take at
    most ``smem_max`` bytes (``_AFFINE_SMEM``) or the chunk is one
    element; the chunk it was made on and those bytes."""
    smem_max = _AFFINE_SMEM if smem_max is None else smem_max
    nd = t.nvpc * t.dim
    vids, pids = t.vtab.vd.cpu().numpy(), t.ptab.vd.cpu().numpy()
    fac = t.fac_vdofs.cpu().numpy() if t.fac_elem.shape[0] else None
    while True:
        if kind == "p":
            part = affine_partition(pids, t.npc, chunk)
            per_elem = t.pnpc
        else:
            joint = kind == "res"
            part = affine_partition(vids, t.nin, chunk, fac,
                                    pids if joint else None, t.npc)
            per_elem = 2 * nd + t.pnpc if joint else nd
        smem = (part["fmax"] + part["emax"] * per_elem) * t.wdet.element_size()
        if smem <= smem_max or chunk == 1:
            return part, chunk, smem
        chunk = max(1, chunk // 2)


def _aff_pad(t, x):
    dt = t.wdet.dtype
    return torch.cat([x.to(dt), x.new_zeros(1, dtype=dt)])


def _aff_segsum(vals, seg, out_dtype):
    """Sum ``vals`` into the segments of a ``(pos, mask)`` gather table,
    each segment's summands in a fixed order."""
    pos, mask = seg
    return (vals.reshape(-1)[pos] * mask).sum(1).to(out_dtype)


def _aff_grad(t, xe):
    """D[e,q,c,d] = d x_c / d x_d at quad points."""
    d = t.dim
    rg = (xe @ t.W2).reshape(t.nc, t.Q, d, d)               # (q,k,c)
    return torch.einsum("edk,eqkc->eqcd", t.JinvT, rg)


def _aff_pullback(t, F):
    """y_e[(a,c)] = sum_q wdet F[e,q,c,d] gphi[e,q,a,d] via W2^T."""
    G = torch.einsum("edk,eqcd->eqkc", t.JinvT, F)
    G = (t.wdet[:, :, None, None] * G).reshape(t.nc, t.dim * t.dim * t.Q)
    return G @ t.W2T


def _aff_facet(t, x, scale):
    if t.fac_elem.shape[0] == 0:
        return None
    xfe = _aff_pad(t, x)[t.fac_vdofs]
    ffe = torch.einsum("fab,fb->fa", t.fac_elem, xfe) * scale
    return _aff_segsum(ffe, t.fseg, ffe.dtype)


def affine_element_terms(mode, x, t, cm=1.0, ca=0.0):
    """Each element's terms of an affine matvec before the sum into the
    dofs: ``fe (nc, ns)`` in the tables' type (``ns`` the element's
    velocity dofs, or its pressure nodes in mode 'j'); slot ``e * ns + j``
    of ``fe.ravel()`` is what :func:`dof_slot_table` numbers.  ``cm, ca``
    as in :func:`affine_mv_ref` ('m' and 'a' set their own)."""
    if mode == "jt":
        dtp = t.wdet.dtype
        qe = _aff_pad(t, x)[t.pdofs]                          # (nc,pnpc)
        qq = torch.einsum("qp,ep->eq", t.N1q, qe)             # (nc,Q)
        eye = torch.eye(t.dim, dtype=dtp, device=qq.device)
        F = qq[:, :, None, None] * eye[None, None]            # (nc,Q,c,d)
        return _aff_pullback(t, F)
    xe = _aff_pad(t, x)[t.vdofs]                              # (nc,2nvpc)
    if mode == "m":
        return t.detJ[:, None] * (xe @ t.MrefI2)
    D = _aff_grad(t, xe)
    if mode == "j":
        div = torch.diagonal(D, dim1=2, dim2=3).sum(-1)       # (nc,Q)
        return (t.wdet * div) @ t.N1q                         # (nc,pnpc)
    if mode == "a":
        cm, ca = 0.0, 1.0
    elif mode != "ma":
        raise ValueError(f"affine_mv mode {mode!r}")
    if t.sym:
        F = (ca * t.nu) * (D + D.transpose(2, 3))
    else:
        F = (ca * t.nu) * D
    fe = _aff_pullback(t, F)
    if cm != 0.0:
        fe = fe + (cm * t.detJ)[:, None] * (xe @ t.MrefI2)
    return fe


def affine_mv_ref(mode, x, t, cm=1.0, ca=0.0):
    """Plain PyTorch version of :func:`affine_mv`: one gather, constant
    Kronecker-expanded weight matrices (``W2``, ``W2T``, ``MrefI2``),
    small per-element geometry einsums (:func:`affine_element_terms`),
    fixed-order segment sums through the ``(pos, mask)`` tables
    ``vseg``/``pseg``/``fseg`` of the tables ``t`` (an
    :class:`..ops.affine.AffineVectorOps`)."""
    fe = affine_element_terms(mode, x, t, cm, ca)
    out = _aff_segsum(fe, t.pseg if mode == "j" else t.vseg, x.dtype)
    if mode in ("a", "ma"):
        corr = _aff_facet(t, x, 1.0 if mode == "a" else ca)
        if corr is not None:
            out = out + corr.to(x.dtype)
    return out


def affine_residual_ref(v, q, t, cm=1.0, ca=0.0):
    """Plain PyTorch version of :func:`affine_residual`: the dense
    solver's three-call composition ``[cm M v + ca A v + J^T q ; J v]``."""
    rv = affine_mv_ref("ma", v, t, cm, ca) + affine_mv_ref("jt", q, t)
    return torch.cat([rv, affine_mv_ref("j", v, t)])


class _AffinePartC(ctypes.Structure):
    # csrc/affine.cu: AffinePart, field for field
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "cnt", "ids", "geo", "fids", "fco", "own", "lell")]
        + [(f, ctypes.c_int) for f in ("nblk", "emax", "fmax", "lwidth",
                                       "nown", "maxown")])


class _AffinePlanC(ctypes.Structure):
    # csrc/affine.cu: AffinePlan, field for field
    _fields_ = ([(f, ctypes.c_void_p) for f in ("qw", "N2", "dN2", "N1")]
                + [(f, ctypes.c_int) for f in (
                    "nc", "nin", "npc", "nfac", "work_f64")])


class _AffineCallC(ctypes.Structure):
    # csrc/affine.cu: AffineCall, field for field
    _fields_ = ([(f, ctypes.c_double) for f in ("cm", "ca", "nu")]
                + [(f, ctypes.c_int) for f in (
                    "mode", "sym", "facets", "x_f64")]
                + [("vb", _AffinePartC), ("pb", _AffinePartC)])


class AffineCall(collections.namedtuple("AffineCall", "c addr nout chunk")):
    """One call's constants in C (``c`` at ``addr``), the output's length
    and the chunk its partition was made on."""


class AffinePlan:
    """Launch plan of ``csrc/affine.cu`` for one table set on one card,
    made at the first call there (never inside a CUDA-graph capture): the
    reference tables' pointers and the sizes in one C structure (``c``, at
    ``addr``), the partitions (made per chunk as :func:`affine_plan` asks,
    packed on the card), the bound C entry points, and one
    :class:`AffineCall` per (mode, cm, ca, vector type), each made at its
    first call, outside a capture too.  The kernel keeps no state between
    launches (no scratch, no counter), so one plan serves every stream,
    and graphs captured with it may replay on any stream, concurrently
    too."""

    def __init__(self, t):
        vd32, pd32 = (tab.vd.to(torch.int32) for tab in (t.vtab, t.ptab))
        nfac = int(t.fac_elem.shape[0])
        self.t, self.nfac = t, nfac
        self.sm = _sm_count(t.wdet.device.index)
        # each element's packed rows: its ids (12 velocity, 3 pressure) and
        # geometry (JinvT, wdet, detJ), 16 entries each
        self._ids16 = torch.cat([vd32, pd32,
                                 torch.full_like(pd32[:, :1], -1)], 1)
        self._geo16 = torch.cat([t.JinvT.reshape(t.nc, -1), t.wdet,
                                 t.detJ[:, None],
                                 t.wdet.new_zeros(t.nc, 16 - 4 - t.Q - 1)],
                                1)
        self._fac = None
        if nfac:
            fv = t.fac_dofs.vd.to(torch.int32)
            self._fac = (fv, t.fac_elem.reshape(-1, fv.shape[1]))
        self.keep, self.parts, self.calls = [], {}, {}
        self.c = _AffinePlanC(_ptr(t.qw), _ptr(t.N2), _ptr(t.dN2),
                              _ptr(t.N1q), t.nc, t.nin, t.npc, nfac,
                              int(t.wdet.dtype == torch.float64))
        self.addr = ctypes.addressof(self.c)
        lib = _affine_lib()
        self.fn, self.empty_fn = lib.affine_th2d, lib.affine_th2d_empty
        self.nu, self.sym = float(t.nu), int(bool(t.sym))
        self.nin, self.npc = t.nin, t.npc

    def partition(self, kind, chunk):
        """``(part, chunk)``: the :class:`_AffinePartC` over chunks of
        ``chunk`` elements, or fewer where its blocks would not fit
        (:func:`affine_fit`), for ``kind`` ``'v'`` (velocity dofs, facet
        rows), ``'p'`` (pressure dofs) or ``'res'`` (both: the residual's
        joint partition), packed on the card at its first use."""
        got = self.parts.get((kind, chunk))
        if got is not None:
            return got
        t, dev = self.t, self.t.wdet.device
        nd = t.nvpc * t.dim
        part, used, smem = affine_fit(t, kind, chunk)
        if smem > _AFFINE_SMEM:
            raise ValueError(
                f"affine kernel: a block of {part['emax']} elements and "
                f"{part['fmax']} facet rows takes {smem} bytes of shared "
                f"memory, at most {_AFFINE_SMEM}, even on chunks of one "
                f"element")
        emax, fmax, nblk = part["emax"], part["fmax"], part["nblk"]
        # block b's element l at row b * emax + l, padding rows -1 / 0
        rows = torch.as_tensor(_packed_rows(part["eptr"], emax), device=dev)
        elem = torch.as_tensor(part["elem"], device=dev).long()
        pid = torch.full((nblk * emax, 16), -1, dtype=torch.int32,
                         device=dev)
        pid[rows] = self._ids16[elem]
        pgeo = t.wdet.new_zeros(nblk * emax, 16)
        pgeo[rows] = self._geo16[elem]
        pfid = pfco = None
        if fmax:
            fac = self._fac
            frows = torch.as_tensor(_packed_rows(part["fptr"], fmax),
                                    device=dev)
            frow = torch.as_tensor(part["frow"], device=dev).long()
            pfid = torch.full((nblk * fmax, nd), -1, dtype=torch.int32,
                              device=dev)
            pfid[frows] = fac[0][frow // nd]
            pfco = fac[1].new_zeros(nblk * fmax, nd)
            pfco[frows] = fac[1][frow]
        cnt, own, lell = (
            torch.as_tensor(np.ascontiguousarray(part[k], dtype=np.int32),
                            device=dev) for k in ("cnt", "own", "lell"))
        self.keep += [pid, pgeo, pfid, pfco, cnt, own, lell]
        got = self.parts[kind, chunk] = (_AffinePartC(
            _ptr(cnt), _ptr(pid), _ptr(pgeo), _ptr(pfid), _ptr(pfco),
            _ptr(own), _ptr(lell), nblk, emax, fmax, part["lell"].shape[0],
            int(own.shape[0]), int(part["cnt"][:, 3].max())), used)
        return got

    def call(self, mode, cm, ca, dtype):
        """The :class:`AffineCall` of ``mode`` ('res' the residual) with
        these constants on vectors of ``dtype``, made at its first use
        (never inside a CUDA-graph capture) and kept."""
        key = (mode, cm, ca, dtype)
        got = self.calls.get(key)
        if got is not None:
            return got
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"affine kernel takes f32 or f64 vectors, not "
                            f"{dtype}")
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the affine kernel's launch constants of mode {mode!r} "
                f"(cm {cm}, ca {ca}, {dtype}) are made at their first "
                f"call: make that call once before capturing")
        kmode = _AFFINE_RES if mode == "res" else _AFFINE_MODES[mode]
        facets = int(kmode in (0, _AFFINE_RES) and ca != 0.0
                     and self.nfac > 0)
        chunk = affine_plan(mode, self.t.nc, self.sm)
        vb = pb = _AffinePartC()
        if mode == "j":
            pb, chunk = self.partition("p", chunk)
        else:
            vb, chunk = self.partition("res" if mode == "res" else "v",
                                       chunk)
        c = _AffineCallC(float(cm), float(ca), self.nu, kmode, self.sym,
                         facets, int(dtype == torch.float64), vb, pb)
        nout = dict(j=self.npc, res=self.nin + self.npc).get(mode, self.nin)
        got = self.calls[key] = AffineCall(c, ctypes.addressof(c), nout,
                                           chunk)
        return got


def _ptr(x):
    return None if x is None else x.data_ptr()


def _packed_rows(ptr, width):
    """Row ``b * width + l`` of each entry ``l`` of segment ``b`` of the
    CSR pointer ``ptr``: where a block's entries go in a padded table."""
    ptr = np.asarray(ptr, np.int64)
    cnt = np.diff(ptr)
    seg = np.repeat(np.arange(len(cnt)), cnt)
    return seg * width + np.arange(ptr[-1]) - ptr[:-1][seg]


def _affine_lib():
    lib = _load("affine")
    if not getattr(lib, "_dns_typed", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.affine_th2d.argtypes = [ptr] * 6
        lib.affine_th2d.restype = i
        lib.affine_th2d_empty.argtypes = [ptr] * 3
        lib.affine_th2d_empty.restype = i
        lib.affine_error_string.argtypes = [i]
        lib.affine_error_string.restype = ctypes.c_char_p
        lib._dns_typed = True
    return lib


def _affine_plan_for(t, dev):
    """The tables' plan on card ``dev``, made (and its checks run) at the
    first call there."""
    plan = t._plans.get(dev)
    if plan is not None:
        return plan
    ok = (torch.float32, torch.float64)
    if t.wdet.dtype not in ok:
        raise TypeError(f"affine kernel takes f32 or f64 tables, not "
                        f"{t.wdet.dtype}")
    if (t.nvpc, t.Q, t.dim, t.pnpc) != (6, 7, 2, 3):
        raise NotImplementedError(
            f"affine kernel: only the 2D Taylor-Hood instantiation (nvpc "
            f"6, Q 7, dim 2, pnpc 3) is built, not "
            f"{(t.nvpc, t.Q, t.dim, t.pnpc)}")
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "the affine kernel's plan is made at its first call: call it "
            "once before capturing")
    plan = t._plans[dev] = AffinePlan(t)
    return plan


def _affine_launch(mode, x, xq, t, cm, ca, empty=False):
    """Launch ``csrc/affine.cu`` on the current stream through the tables'
    plan for it; returns ``y`` in ``x``'s type.  ``empty``: launch an
    empty kernel on the same grid instead (the latency floor; returns
    None)."""
    dev = x.get_device()
    stream = _raw_stream(dev)
    plan = t._plans.get(dev) or _affine_plan_for(t, dev)
    call = plan.call(mode, cm, ca, x.dtype)
    with _on_device(dev):
        if empty:
            err, y = plan.empty_fn(plan.addr, call.addr, stream), None
        else:
            y = x.new_empty(call.nout)
            err = plan.fn(plan.addr, call.addr, x.data_ptr(),
                          None if xq is None else xq.data_ptr(),
                          y.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"affine kernel launch failed (mode {mode!r}, chunk "
            f"{call.chunk}, nc {t.nc}, nin {t.nin}, {plan.nfac} facet "
            f"blocks): "
            f"{_affine_lib().affine_error_string(err).decode()}")
    return y


def _affine_ok(x, n, t):
    """``x`` a 1-D tensor of ``n`` entries on the tables' device (the
    per-call check; :func:`_affine_check` says what is wrong)."""
    return (torch.is_tensor(x) and x.dim() == 1 and x.shape[0] == n
            and x.get_device() == t.wdet.get_device())


def _affine_check(name, x, n, t, what="x"):
    if not torch.is_tensor(x) or x.dim() != 1 or x.shape[0] != n:
        raise ValueError(
            f"{name}: {what} must be a 1-D tensor of {n} dofs, got "
            f"{tuple(getattr(x, 'shape', ()))}")
    if x.get_device() != t.wdet.get_device():
        raise ValueError(f"{name}: {what} is on {x.device}, the tables on "
                         f"{t.wdet.device}")


def affine_mv(mode, x, tables, cm=1.0, ca=0.0):
    """The affine element matvecs of :class:`..ops.affine.AffineVectorOps`
    (``tables``): ``mode`` 'm' (``M x``), 'a' (``A x``, with its facet
    rows), 'ma' (``cm M x + ca A x``; host scalars), 'j' (``J x``, over
    the condensed pressure dofs) or 'jt' (``J^T x`` for a pressure vector
    ``x``).  Arithmetic in the tables' type, result in ``x``'s.

    On a CUDA tensor this launches the hand-written kernel of
    ``csrc/affine.cu`` (one device kernel with no grid-wide wait, the mode
    an argument, the chunks :func:`affine_plan`'s) on the current stream,
    through the tables' :class:`AffinePlan` on that card, and counts it
    in ``affine_mv.launches`` (and by mode in ``affine_mv.mode_launches``);
    on a CPU tensor it is :func:`affine_mv_ref`."""
    if mode not in _AFFINE_MODES:
        raise ValueError(f"affine_mv mode {mode!r}")
    n = tables.npc if mode == "jt" else tables.nin
    if not _affine_ok(x, n, tables):
        _affine_check(f"affine_mv {mode!r}", x, n, tables)
    if mode == "m":
        cm, ca = 1.0, 0.0
    elif mode == "a":
        cm, ca = 0.0, 1.0
    if not x.is_cuda:
        return affine_mv_ref(mode, x, tables, cm, ca)
    y = _affine_launch(mode, x.contiguous(), None, tables, cm, ca)
    affine_mv.launches += 1
    affine_mv.mode_launches[mode] += 1
    return y


affine_mv.launches = 0
affine_mv.mode_launches = dict.fromkeys(_AFFINE_MODES, 0)


def affine_residual(v, q, tables, cm=1.0, ca=0.0):
    """The residual of the dense solver's refinement round in one call:
    ``[cm M v + ca A v (+ its facet rows) + J^T q ; J v]`` (``nin + npc``)
    in ``v``'s type, ``v`` and ``q`` of one type; the function of
    ``affine_mv('ma', v) + affine_mv('jt', q)`` and ``affine_mv('j', v)``.

    On a CUDA tensor this launches the kernel of ``csrc/affine.cu`` in its
    residual mode (one launch for the three matvecs: each velocity dof
    sums its ``K`` terms and its ``J^T`` terms in their slot order and adds
    the two in ``v``'s type, as the composition does) and counts it in
    ``affine_residual.launches``; on a CPU tensor it is
    :func:`affine_residual_ref`."""
    if not (_affine_ok(v, tables.nin, tables)
            and _affine_ok(q, tables.npc, tables)):
        _affine_check("affine_residual", v, tables.nin, tables, "v")
        _affine_check("affine_residual", q, tables.npc, tables, "q")
    if q.dtype != v.dtype:
        raise TypeError(f"affine_residual: v is {v.dtype}, q {q.dtype}")
    if not v.is_cuda:
        return affine_residual_ref(v, q, tables, cm, ca)
    y = _affine_launch("res", v.contiguous(), q.contiguous(), tables, cm, ca)
    affine_residual.launches += 1
    return y


affine_residual.launches = 0
