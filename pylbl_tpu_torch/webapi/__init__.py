from .arts_crossfit_api import download as download_arts_crossfit  # noqa: F401
from .hitran_api import (HitranWebApi, NoCrossSectionError,  # noqa: F401
                         NoIsotopologueError, NoTransitionsError,
                         Struct, parse_transitions, query_string)
from .tips_api import NoMoleculeError, TipsWebApi  # noqa: F401
