"""The port's pass pipeline: registry, the slice's passes, and pipelines."""

from .pass_manager import (Pass, PassManager, expand_pipeline, register,
                           register_pipeline, run_pipeline)

# importing registers the passes
from . import attention as _attention      # noqa: F401
from . import chain as _chain              # noqa: F401
from . import cleanup as _cleanup          # noqa: F401
from . import fold as _fold                # noqa: F401
from . import fuse as _fuse                # noqa: F401
from . import pipelines as _pipelines      # noqa: F401
from . import to_xsmm as _to_xsmm          # noqa: F401

__all__ = ["Pass", "PassManager", "expand_pipeline", "register",
           "register_pipeline", "run_pipeline"]
