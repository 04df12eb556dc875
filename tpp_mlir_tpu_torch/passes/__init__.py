"""The port's pass pipeline: registry, the passes, and the bundles."""

from .pass_manager import (Pass, PassManager, available_passes,
                           available_pipelines, expand_pipeline, make_pass,
                           register, register_pipeline, run_pipeline)

# importing registers the passes
from . import attention as _attention      # noqa: F401
from . import chain as _chain              # noqa: F401
from . import cleanup as _cleanup          # noqa: F401
from . import conv as _conv                # noqa: F401
from . import fold as _fold                # noqa: F401
from . import fuse as _fuse                # noqa: F401
from . import generic_lower as _generic    # noqa: F401
from . import pack as _pack                # noqa: F401
from . import pipelines as _pipelines      # noqa: F401
from . import split_reduction as _splitred  # noqa: F401
from . import to_xsmm as _to_xsmm          # noqa: F401

__all__ = [
    "Pass", "PassManager", "available_passes", "available_pipelines",
    "expand_pipeline", "make_pass", "register", "register_pipeline",
    "run_pipeline",
]
