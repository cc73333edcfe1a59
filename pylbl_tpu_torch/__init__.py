"""pylbl_tpu_torch — the line-by-line gas-optics framework on PyTorch.

The PyTorch/CUDA counterpart of ``pylbl_tpu`` (the JAX package beside it,
which stays the numerical reference).  Module paths mirror the JAX
package's.  The main path — :class:`Spectroscopy` ``compute_absorption``
over a layer batch, all gases' lines in one stacked device pipeline —
runs hand-written CUDA kernels for Hopper (ops/lineshape_cuda.py,
csrc/lineshape.cu) on the card and their plain PyTorch versions on the
CPU.  This package imports torch and never jax or pylbl_tpu.
"""
from .atmosphere import Atmosphere  # noqa: F401
from .models.lines import Gas, LinePack  # noqa: F401
from .models.tips import TotalPartitionFunction  # noqa: F401
from .utils.xrlite import DataArray, Dataset, open_dataset  # noqa: F401

from .database import Database  # noqa: F401
from .spectroscopy import Spectroscopy  # noqa: F401
from .plugins import continua, cross_sections, models, molecular_lines  # noqa: F401

__version__ = "0.1.0"
