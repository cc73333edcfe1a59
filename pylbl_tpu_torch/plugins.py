"""Backend plugin registry (counterpart of pylbl_tpu/plugins.py).

The same dictionary surface as the reference (reference
pyLBL/plugins.py:7-34): ``molecular_lines`` / ``continua`` /
``cross_sections`` keyed by backend name, unknown names raising KeyError,
with the built-in backends registered (and the optional "arts" lines
backend when pyarts imports), the ``register_*`` hooks, and
entry-point discovery in group "pylbl_tpu_torch" at import, so
third-party backends plug in without this package importing them
eagerly.  The group is not the JAX package's "pylbl_tpu": its entry
points name ``pylbl_tpu`` classes, and loading them would import JAX.
"""
from re import match

from .models import arts_frontend, mt_ckd
from .models.arts_crossfit import CrossSection
from .models.lines import Gas

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

# The optional ARTS lines backend, registered when pyarts imports
# (reference setup.py:56).
if arts_frontend.ARTS_INSTALLED:
    molecular_lines["arts"] = arts_frontend.PyArtsGas

models = list({*molecular_lines, *continua, *cross_sections})


def register_lines_backend(name, cls):
    molecular_lines[name] = cls
    _refresh_models()


def register_continua_backend(name, class_map):
    continua[name] = dict(class_map)
    _refresh_models()


def register_cross_sections_backend(name, cls):
    cross_sections[name] = cls
    _refresh_models()


def _refresh_models():
    global models
    models = list({*molecular_lines, *continua, *cross_sections})


def discover_entry_points(group="pylbl_tpu_torch"):
    """Loads third-party backends advertised via importlib entry points.

    Entry-point names follow the reference convention: ``Gas`` for a lines
    backend, ``CrossSection`` for cross sections, ``<Molecule>Continuum``
    for continuum classes (reference plugins.py:12-34); the entry point's
    *value* module path groups them under its distribution name.
    """
    from importlib.metadata import entry_points

    pending_continua = {}
    for ep in entry_points(group=group):
        backend = ep.value.split(":")[0].split(".")[0]
        if ep.name == "Gas":
            molecular_lines[backend] = ep.load()
        elif ep.name == "CrossSection":
            cross_sections[backend] = ep.load()
        else:
            m = match(r"([A-Za-z0-9]+)Continuum", ep.name)
            if m:
                pending_continua.setdefault(backend, {})[m.group(1)] = \
                    ep.load()
    for backend, class_map in pending_continua.items():
        continua.setdefault(backend, {}).update(class_map)
    _refresh_models()


discover_entry_points()
