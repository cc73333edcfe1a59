"""Backend plugin registry (counterpart of pylbl_tpu/plugins.py).

The same dictionary surface as the reference (reference
pyLBL/plugins.py:7-34): ``molecular_lines`` / ``continua`` /
``cross_sections`` keyed by backend name, unknown names raising KeyError,
with the built-in backends registered.  Entry-point discovery and the
``register_*`` hooks are not ported.
"""
from .models.arts_crossfit import CrossSection
from .models.lines import Gas
from .models import mt_ckd

# Lines backends: key = model name, value = Gas-like class
# (duck type: __init__(database, formula) +
#  absorption_coefficient(T, p, vmr, grid, remove_pedestal, cut_off)).
molecular_lines = {
    "pyLBL": Gas,          # reference-compatible name.
    "pylbl_tpu": Gas,
}

# Continuum backends: key = model name, value = dict of molecule-key ->
# BandedContinuum class ("H2OSelf"/"H2OForeign"/formula, reference
# plugins.py:26-34).
continua = {
    "mt_ckd": {
        "CO2": mt_ckd.CarbonDioxideContinuum,
        "H2OForeign": mt_ckd.WaterVaporForeignContinuum,
        "H2OSelf": mt_ckd.WaterVaporSelfContinuum,
        "N2": mt_ckd.NitrogenContinuum,
        "O2": mt_ckd.OxygenContinuum,
        "O3": mt_ckd.OzoneContinuum,
    },
}

# Cross-section backends: key = model name, value = CrossSection-like class.
cross_sections = {
    "arts_crossfit": CrossSection,
}

models = list({*molecular_lines, *continua, *cross_sections})
