from . import constants  # noqa: F401
from .xrlite import DataArray, Dataset, open_dataset  # noqa: F401
