"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

One kernel so far: the dense inverse apply ``y = x @ KT``
(``csrc/vecmat.cu``), the counterpart of the JAX package's only Pallas
kernel ``ops/pallas_kernels.py: vecmat_pallas``.  It streams the full
dense saddle inverse from device memory once per time step — the
bandwidth floor of the dense-solver time loop.

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
