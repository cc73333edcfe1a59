"""The control of the check: the plain reference put in the program's place
and computed a precision lower (``lbl.absorption(..., "bfloat16")``), with
the pedestal taken out where the configuration states it.  It
answers each request at the points the check reads, laid out as the
program's [states, grid] spectrum (NaN elsewhere), and a run with it in
the program's place has to come out not correct."""
import numpy as np

from ..reference import lbl
from .spec import remove_pedestal


class Control:
    """A system under test (as :class:`system.System`) that is the
    reference in bfloat16."""

    def __init__(self, config, traffic, inputs, workdir, device):
        self.config = config
        self.inputs = inputs
        self.device = device
        self.remove_pedestal = remove_pedestal(config)

    def __call__(self, request):
        atm = request.atmosphere
        out = np.full((atm.num_states, self.inputs.grid.size), np.nan)
        out[request.state, request.point] = lbl.absorption(
            self.config, self.inputs.lines, atm, self.inputs.grid,
            request.state, request.point, "bfloat16", self.device,
            self.remove_pedestal)
        return out

    def close(self):
        pass
