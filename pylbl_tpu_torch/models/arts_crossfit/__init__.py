from .cross_section import (CrossSection, calculate_xsec,  # noqa: F401
                            calculate_xsec_fullmodel,
                            calculate_xsec_fullmodel_batch)
from ...webapi.arts_crossfit_api import download  # noqa: F401
