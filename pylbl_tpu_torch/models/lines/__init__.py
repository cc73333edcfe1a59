from .gas import Gas, internal_grid  # noqa: F401
from .physics import LinePack, kernel_inputs, line_profile_params  # noqa: F401
