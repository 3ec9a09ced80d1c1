"""dolfin_navier_scipy_tpu_torch — the PyTorch/CUDA port of
``dolfin_navier_scipy_tpu`` for one NVIDIA Hopper card.

Same sub-package layout and public names as the JAX package (``mesh fem
ops models solve utils``), so every module has its counterpart:

* meshes, FEM spaces and the Stokes operator family are compiled host-side
  (numpy/scipy) into static index arrays,
* the affine-factorized matvecs, the dense saddle inverse and the whole
  CNAB / SBDF2 time loops run as torch tensors on the card,
* the dense inverse apply — the one hand-written kernel of the JAX
  package — and the fused element pipeline of the convection vector are
  hand-written CUDA kernels here (``csrc/vecmat.cu``,
  ``csrc/convection.cu``, bound in :mod:`.ops.kernels`).

Every entry point takes an explicit ``device``; ``device=None`` means the
card (:func:`default_device` raises when there is none).  The package
imports ``torch``, numpy and scipy — never ``jax`` and nothing of the JAX
package.
"""

import torch as _torch

# FEM solves need true-f32 products: the increment-form integrators budget
# ~1e-7 per operator application, which TF32's 10-bit mantissa destroys.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from .device import default_device, resolve_device  # noqa: E402,F401
from . import fem, mesh, ops, solve, models, utils  # noqa: E402,F401
