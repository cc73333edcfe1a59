from .cross_section import (CrossSection,  # noqa: F401
                            calculate_xsec_fullmodel_batch)
