from .voigt import voigt_full, voigt_lorentz, voigt_correction  # noqa: F401
