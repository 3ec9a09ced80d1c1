"""Operator assembly (host compile-time) and device kernels (run time)."""

from .assemble import AssemblyContext, assemble_stokes, assemble_rhs  # noqa: F401
from .convection import (  # noqa: F401
    ConvectionKernel,
    convection_matrices_host,
    convection_vector_host,
)
from .sparse import EllMatrix  # noqa: F401
from .affine import AffineVectorOps, OpView  # noqa: F401
from .kernels import (  # noqa: F401
    DofTable,
    affine_mv,
    affine_mv_ref,
    affine_residual,
    affine_residual_ref,
    as_vecmat_operand,
    conv_vector,
    conv_vector_amatvec,
    conv_vector_amatvec_ref,
    conv_vector_ref,
    vecmat,
    vecmat_operand,
    vecmat_ref,
)
from . import condense  # noqa: F401
