"""Optional ARTS lines backend, the pyarts bridge (counterpart of
pylbl_tpu/models/arts_frontend.py).

The reference's pyarts frontend (reference
pyLBL/pyarts_frontend/frontend.py:13-142): database transition rows become
ARTS absorption-line structures, and a propagation-matrix workspace agenda
is evaluated on the host.  pyarts is an optional dependency: without it
this module still imports, :class:`PyArtsGas` raises ``ValueError``, and
plugins.py does not register the "arts" lines backend.

Transition rows are tuples of (nu, sw, gamma_air, gamma_self, n_air,
elower, delta_air, local_iso_id), the columns of ``Database.gas(formula)[2]``
and of a LinePack.
"""
from logging import getLogger

logger = getLogger("pylbl_tpu_torch.arts")

try:
    import pyarts
    ARTS_INSTALLED = True
except ImportError:
    pyarts = None
    ARTS_INSTALLED = False
    logger.info("pyarts is not installed; the 'arts' lines backend is "
                "unavailable.")


def _iso_code(local_iso_id):
    """HITRAN local isotopologue id -> ARTS code: 11 and 12 are the letters
    A and B (reference frontend.py:23-28), the others their digits."""
    return {11: "A", 12: "B"}.get(local_iso_id, str(local_iso_id))


def _species_model(convert, gamma, n_air, delta_air):
    """One broadening species' line-shape model: a T1 pressure width and
    a T0 shift, converted from cm-1/atm to Hz/Pa."""
    parameters = pyarts.arts.LineShapeModelParameters
    return pyarts.arts.LineShapeSingleSpeciesModel(
        G0=parameters("T1", convert.kaycm_per_atm2hz_per_pa(gamma), n_air),
        D0=parameters("T0", convert.kaycm_per_atm2hz_per_pa(delta_air)))


def absorption_line(molecule_id, nu, sw, gamma_air, gamma_self, n_air,
                    elower, delta_air, local_iso_id):
    """One transition -> (QuantumIdentifier, AbsorptionSingleLine), with the
    self model before the air model and the strength divided by the
    isotopologue ratio."""
    iso = _iso_code(local_iso_id)
    convert = pyarts.arts.convert
    ratio = pyarts.arts.hitran.ratio(molecule_id, iso)
    qkey = pyarts.arts.hitran.quantumidentity(molecule_id, iso)
    lineshape = pyarts.arts.LineShapeModel([
        _species_model(convert, gamma_self, n_air, delta_air),
        _species_model(convert, gamma_air, n_air, delta_air)])
    line = pyarts.arts.AbsorptionSingleLine(
        F0=convert.kaycm2freq(nu),
        I0=convert.kaycm_per_cmsquared2hz_per_msquared(sw / ratio),
        E0=convert.kaycm2joule(elower),
        lineshape=lineshape)
    return qkey, line


def absorption_lines(molecule_id, transitions):
    """Transition rows -> ArrayOfAbsorptionLines, one band per quantum
    identity in first-seen order (SplitVP line shape, SFS normalization,
    no cutoff: reference frontend.py:81-97)."""
    bands = {}
    for row in transitions:
        qkey, line = absorption_line(molecule_id, *row)
        bands.setdefault(str(qkey), []).append(line)
    out = pyarts.arts.ArrayOfAbsorptionLines()
    for key, lines in bands.items():
        out.append(pyarts.arts.AbsorptionLines(
            selfbroadening=True, bathbroadening=True, cutoff="None",
            mirroring="None", population="LTE", normalization="SFS",
            lineshapetype="SplitVP", quantumidentity=key,
            broadeningspecies=[key.split("-")[0], "Bath"], T0=296,
            lines=lines))
    return out


class PyArtsGas:
    """ARTS-backed lines engine (the duck type of models.lines.Gas).  It
    runs on the host: ``Spectroscopy`` passes it only the keywords it
    declares, so it takes no device, dtype or backend."""

    def __init__(self, lines_database, formula):
        if not ARTS_INSTALLED:
            raise ValueError("pyarts is not installed.")
        pack = lines_database.line_pack(formula)
        rows = list(zip(pack.nu, pack.sw, pack.gamma_air, pack.gamma_self,
                        pack.n_air, pack.elower, pack.delta_air, pack.iso))
        ws = pyarts.workspace.Workspace()
        ws.abs_speciesSet(species=[formula])
        ws.abs_lines_per_species = [absorption_lines(1, rows)]
        ws.jacobianOff()
        for name in ("rtp_nlte", "rtp_mag", "rtp_los"):
            ws.Touch(getattr(ws, name))
        ws.propmat_clearsky_agendaAuto()
        ws.lbl_checkedCalc()
        ws.stokes_dim = 1
        self.ws = ws

    def absorption_coefficient(self, temperature, pressure,
                               volume_mixing_ratio, grid,
                               remove_pedestal=False, cut_off=25):
        """Absorption cross sections [m2] from the ARTS propagation-matrix
        agenda, divided by the gas's number density (reference
        frontend.py:116-142)."""
        ws = self.ws
        ws.f_grid = pyarts.arts.convert.kaycm2freq(grid)
        ws.rtp_pressure = pressure
        ws.rtp_temperature = temperature
        ws.rtp_vmr = [volume_mixing_ratio]
        ws.AgendaExecute(a=ws.propmat_clearsky_agenda)
        density = pyarts.arts.physics.number_density(
            pressure, temperature) * volume_mixing_ratio
        return ws.propmat_clearsky.value.data.value.flatten() / density
