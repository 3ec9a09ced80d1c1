"""Device sparse-matrix format: a torch sparse CSR tensor.

``EllMatrix`` keeps the name and the ``matvec`` interface of the JAX
package's padded-ELL container so callers read the same, but holds the
matrix in CSR — row-pointer SpMV is native on a GPU and needs no padding.

Replaces scipy CSR matvecs of the reference's inner loops
(e.g. time_int_utils.py:125-128 ``M*v_c - .5*dt*A*v_c``).
"""

import warnings
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sps
import torch

from ..device import resolve_device


@dataclass
class EllMatrix:
    """Sparse matrix on the device; ``mat`` is a torch sparse CSR tensor."""

    mat: torch.Tensor
    shape: tuple

    @classmethod
    def from_scipy(cls, mat, dtype=None, device=None):
        """Convert any scipy sparse matrix."""
        device = resolve_device(device)
        csr = sps.csr_matrix(mat)
        csr.sum_duplicates()
        dtype = dtype or torch.float64
        with warnings.catch_warnings():
            # torch announces its CSR support as beta on first use
            warnings.simplefilter("ignore", UserWarning)
            t = torch.sparse_csr_tensor(
                torch.from_numpy(csr.indptr.astype(np.int64)),
                torch.from_numpy(csr.indices.astype(np.int64)),
                torch.from_numpy(csr.data).to(dtype),
                size=csr.shape, check_invariants=False).to(device)
        return cls(t, tuple(csr.shape))

    def matvec(self, x):
        """``A @ x`` for ``x (m,)`` -> ``(n,)``."""
        return torch.mv(self.mat, x.to(self.mat.dtype))

    def __matmul__(self, x):
        return self.matvec(x)


def ell_from_scipy_fast(mat, dtype=None, device=None) -> EllMatrix:
    """scipy -> device sparse matrix (name kept from the JAX package)."""
    return EllMatrix.from_scipy(mat, dtype=dtype, device=device)
