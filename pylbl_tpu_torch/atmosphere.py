"""Atmospheric input adaptation.

Copy of the CF-name discovery of pylbl_tpu/atmosphere.py, a
re-implementation of the reference input layer (reference
pyLBL/atmosphere.py:21-87).  It discovers pressure, temperature and gas
mole-fraction variables in a dataset either by CF ``standard_name``
attributes or via an explicit user mapping.
"""
from re import match


# Map of CF molecule standard names to chemical formulae
# (reference pyLBL/atmosphere.py:7-18).
STANDARD_NAME_TO_FORMULA = {
    "carbon_dioxide": "CO2",
    "carbon_monoxide": "CO",
    "cfc11": "CFC11",
    "cfc12": "CFC12",
    "methane": "CH4",
    "nitrogen": "N2",
    "nitrous_oxide": "N2O",
    "oxygen": "O2",
    "ozone": "O3",
    "water_vapor": "H2O",
}


def _find_variable(dataset, standard_name):
    """Finds a variable in a dataset by its CF standard_name attribute.

    Raises:
        ValueError: if the standard name is not present
        (same contract as reference pyLBL/atmosphere.py:50-69).
    """
    for var in dataset.data_vars.values():
        try:
            if var.attrs["standard_name"] == standard_name:
                return var
        except KeyError:
            continue
    raise ValueError(f"{standard_name} standard name not found in dataset.")


def _gases(dataset):
    """Yields (formula, variable) for CF mole-fraction variables.

    Mirrors reference pyLBL/atmosphere.py:72-87.
    """
    for var in dataset.data_vars.values():
        try:
            m = match(r"mole_fraction_of_([A-Za-z0-9_]+)?_in_air",
                      var.attrs["standard_name"])
        except KeyError:
            continue
        if m:
            yield STANDARD_NAME_TO_FORMULA[m.group(1)], var


class Atmosphere:
    """Atmospheric data container with CF-convention data discovery.

    Attributes:
        dataset: the input dataset (xarray.Dataset or pylbl_tpu_torch Dataset).
        pressure: DataArray of pressure [Pa].
        temperature: DataArray of temperature [K].
        gases: dict of formula -> DataArray of mole fraction [mol mol-1].
    """

    def __init__(self, dataset, mapping=None):
        self.dataset = dataset
        if mapping is None:
            self.pressure = _find_variable(dataset, "air_pressure")
            self.temperature = _find_variable(dataset, "air_temperature")
            self.gases = {x: y for x, y in _gases(dataset)}
        else:
            self.pressure = dataset[mapping["play"]]
            self.temperature = dataset[mapping["tlay"]]
            self.gases = {x: dataset[y]
                          for x, y in mapping["mole_fraction"].items()}
