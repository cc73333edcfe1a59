from . import native  # noqa: F401
