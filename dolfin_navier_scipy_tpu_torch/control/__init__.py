"""Control: LTI observer/feedback discretizations, controller-in-the-loop
augmentation, Robin and Dirichlet boundary control helpers."""

from .lti import get_heunab_lti, get_heuntrpz_lti  # noqa: F401
from .augment import nse_include_lnrcntrllr  # noqa: F401
from .robin import apply_robin_penalty  # noqa: F401
