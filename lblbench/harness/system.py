"""The system under test: the port's public entry, driven as a user drives
it.  Set-up ingests the line lists through ``Database.ingest_line_pack``
into a database file under ``workdir``, and the user keeps that
``Database``.  The atmosphere of a ``Spectroscopy`` is fixed when it is
built, so each request builds a new one over the request's atmosphere and
calls ``compute_absorption(output_format="total", remove_pedestal=...)``
(the configuration's ``remove_pedestal``),
with the spectrum handed back on the host.  The continua run on the device
(``device_mechanisms``: the default on the card, asked for here so that the
CPU tests take the same path).  Nothing else of the program is used."""
import numpy as np

from .spec import remove_pedestal

# CF standard names of the gases (the port's ``atmosphere.py`` reads them).
STANDARD_NAMES = {"H2O": "water_vapor", "CO2": "carbon_dioxide",
                  "O3": "ozone", "N2O": "nitrous_oxide", "CO":
                  "carbon_monoxide", "CH4": "methane", "O2": "oxygen",
                  "N2": "nitrogen"}


def dataset(P, atmosphere):
    """The atmosphere as the port's CF-convention Dataset."""
    shape, dims = atmosphere.shape, atmosphere.dims
    data = {"p": (dims, atmosphere.p.reshape(shape),
                  {"standard_name": "air_pressure", "units": "Pa"}),
            "t": (dims, atmosphere.t.reshape(shape),
                  {"standard_name": "air_temperature", "units": "K"})}
    for name, values in atmosphere.vmr.items():
        data[name.lower()] = (dims, values.reshape(shape), {
            "standard_name":
                f"mole_fraction_of_{STANDARD_NAMES[name]}_in_air",
            "units": "mol mol-1"})
    return P.Dataset(data_vars=data)


class System:
    """The run's ``Database``; calling it with a request runs the request
    and returns the spectrum as a [states, grid] numpy array."""

    def __init__(self, config, traffic, inputs, workdir, device):
        import pylbl_tpu_torch as P
        from pylbl_tpu_torch.models.lines.physics import LinePack

        self.P = P
        self.db = P.Database(workdir / "lines.sqlite")
        for name, lines in inputs.lines.items():
            self.db.ingest_line_pack(LinePack(formula=name, **lines))
        self.grid = inputs.grid
        self.device = device
        self.remove_pedestal = remove_pedestal(config)

    def __call__(self, request):
        atm = request.atmosphere
        spec = self.P.Spectroscopy(dataset(self.P, atm), self.grid, self.db,
                                   device_mechanisms=True,
                                   device=self.device)
        out = spec.compute_absorption(output_format="total",
                                      remove_pedestal=self.remove_pedestal)
        return np.asarray(out["absorption"].data).reshape(atm.num_states, -1)

    def close(self):
        self.db = None
