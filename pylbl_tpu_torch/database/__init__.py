from . import fixtures  # noqa: F401
from .db import (AliasNotFoundError, CrossSectionNotFoundError,  # noqa: F401
                 Database, IsotopologuesNotFoundError, TipsDataNotFoundError,
                 TransitionsNotFoundError)
