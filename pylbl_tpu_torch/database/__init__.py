from .db import (AliasNotFoundError, CrossSectionNotFoundError,  # noqa: F401
                 Database, IsotopologuesNotFoundError, TipsDataNotFoundError,
                 TransitionsNotFoundError)
