"""A run's inputs, made from ``--seed``: the line lists and, for each
request by its index, the atmosphere and the output points that the check
compares.

The line lists are the repository's HITRAN-like fixture
(``pylbl_tpu_torch/database/fixtures.py`` ``synthetic_line_pack``, copied
here so that the yardstick does not move with the program): positions
clustered round band centres over a uniform background, intensities
log-uniform over eight decades, broadening in HITRAN's ranges and TIPS-like
partition tables.  The atmosphere is the canonical column
(``pylbl_tpu_torch/tools`` ``canonical_layers``: 117-98388 Pa, log-p
interpolation) with each site's temperature and mole fractions perturbed
by amounts drawn from the seed and the request's index, small enough to
leave the work the same from request to request, so that every request of
a run is another atmosphere.  The same arrays go to the program and to
the plain reference.
"""
from dataclasses import dataclass

import numpy as np

# Output points the check compares in a request, spread over its states.
CHECK_POINTS = 4096
# Calls of the window the check compares, drawn from the seed.
CHECKED_CALLS = 6


def _tips(rng, num_iso, num_t=5000):
    """TIPS-like tables on the 1 K grid T = 1..num_t: Q ~ T^1.5 per
    isotopologue (the fixture's ``synthetic_tips``)."""
    temperature = np.arange(1.0, num_t + 1.0)
    scale = rng.uniform(0.5, 6.0, size=num_iso)
    power = rng.uniform(1.0, 1.8, size=num_iso)
    data = scale[:, None] * (temperature[None, :] / 296.0) ** power[:, None] \
        * 160.0 + 1.0
    return temperature, data


def line_list(rng, tips_rng, num_lines, nu_min, nu_max, num_iso,
              band_centers, band_width):
    """One molecule's nu-sorted line list as a dict of float64 / int64
    arrays (the fixture's ``synthetic_line_pack``)."""
    n_band = int(num_lines * 0.7) // max(len(band_centers), 1)
    nus = [rng.uniform(nu_min, nu_max,
                       size=num_lines - n_band * len(band_centers))]
    for center in band_centers:
        nus.append(np.clip(rng.normal(center, band_width, size=n_band),
                           nu_min, nu_max))
    nu = np.sort(np.concatenate(nus))
    num = nu.size
    lines = {
        "nu": nu,
        "sw": 10.0 ** rng.uniform(-28.0, -20.0, size=num),
        "gamma_air": rng.uniform(0.01, 0.12, size=num),
        "gamma_self": rng.uniform(0.05, 0.6, size=num),
        "n_air": rng.uniform(0.3, 0.9, size=num),
        "delta_air": rng.uniform(-0.02, 0.02, size=num),
        "elower": rng.uniform(0.0, 4000.0, size=num),
        "iso": rng.integers(1, num_iso + 1, size=num).astype(np.int64),
    }
    mass_slots = np.zeros(32)
    mass_slots[:num_iso] = 18.010565 + np.arange(num_iso)
    lines["mass_slots"] = mass_slots
    lines["q_temperature"], lines["q_table"] = _tips(tips_rng, num_iso)
    return lines


def line_lists(config, seed):
    """{gas: line list} of the configuration's line-bearing gases, gas g
    drawn from the generators seeded (seed, g) and (seed, g, 1), its band
    centres at ``150 + band_step * g``, then the shared bands (the JAX
    bench's ``multigas_packs`` layout)."""
    gen = config["lines"]
    out = {}
    for g, (name, count) in enumerate(gen["counts"].items()):
        centers = (gen["first_band"] + gen["band_step"] * g,
                   *gen["shared_bands"])
        out[name] = line_list(np.random.default_rng([seed, g]),
                              np.random.default_rng([seed, g, 1]),
                              count, gen["nu_min"], gen["nu_max"],
                              gen["isotopologues"], centers,
                              gen["band_width"])
    return out


def canonical_column(profile, num_layers):
    """(t, p, {gas: mole fraction}) of ``num_layers`` layers spanning the
    profile's levels: pressure log-spaced from its first to its last
    level, temperature and mole fractions interpolated in log pressure."""
    levels_p = np.asarray(profile["pressure"], np.float64)
    order = np.argsort(levels_p)
    logp = np.log(levels_p[order])
    p = np.geomspace(levels_p[0], levels_p[-1], num_layers)
    t = np.interp(np.log(p), logp,
                  np.asarray(profile["temperature"], np.float64)[order])
    vmr = {name: np.interp(np.log(p), logp,
                           np.asarray(values, np.float64)[order])
           for name, values in profile["mole_fraction"].items()}
    return t, p, vmr


@dataclass
class Atmosphere:
    """Sites x layers of float64 conditions: ``t`` and ``p`` [sites,
    layers], ``vmr`` {gas: [sites, layers]}; ``dims`` are the output's
    leading dimensions."""
    t: np.ndarray
    p: np.ndarray
    vmr: dict
    dims: tuple

    @property
    def shape(self):
        return self.t.shape if len(self.dims) == 2 else self.t.shape[1:]

    @property
    def num_states(self):
        return self.t.size

    def flat(self):
        """(t, p, vmr) flattened in the output's state order."""
        return (self.t.ravel(), self.p.ravel(),
                {k: v.ravel() for k, v in self.vmr.items()})


def atmosphere(config, seed, call):
    """The atmosphere of request ``call``: ``config["sites"]`` copies of
    the canonical column, each layer's temperature moved by a uniform
    amount within +/- ``t_kelvin`` and each mole fraction scaled by one
    within 1 +/- ``vmr_relative``, drawn from (seed, call), so that every
    request of a run is another.  One site gives a ("layer",) atmosphere,
    more a ("site", "layer") one."""
    t0, p0, vmr0 = canonical_column(config["profile"], config["layers"])
    sites = config["sites"]
    pert = config["perturbation"]
    rng = np.random.default_rng([seed, 1000, call])
    shape = (sites, t0.size)
    t = t0 + rng.uniform(-pert["t_kelvin"], pert["t_kelvin"], size=shape)
    p = np.broadcast_to(p0, shape).copy()
    vmr = {name: v * (1.0 + rng.uniform(-pert["vmr_relative"],
                                        pert["vmr_relative"], size=shape))
           for name, v in vmr0.items()}
    dims = ("layer",) if sites == 1 else ("site", "layer")
    return Atmosphere(t=t, p=p, vmr=vmr, dims=dims)


def user_grid(config):
    """The configuration's wavenumber grid [cm-1] as the user passes it."""
    g = config["grid"]
    return np.arange(g["start"], g["stop"], g["step"])


def sample(config, seed, call, centers, num_states, grid_size):
    """The points of request ``call`` that the check compares, drawn from
    (seed, call): (state, point) index arrays, ``CHECK_POINTS`` spread
    evenly over the states, half of them anywhere on the grid and half at
    the grid point nearest the centre of a line drawn from ``centers``
    (where the Voigt core does the work)."""
    per_state = -(-CHECK_POINTS // num_states)
    rng = np.random.default_rng([seed, 2000, call])
    g = config["grid"]
    state = np.repeat(np.arange(num_states), per_state)
    anywhere = rng.integers(0, grid_size, size=state.size)
    near = np.rint((rng.choice(centers, size=state.size) - g["start"])
                   / g["step"]).astype(np.int64)
    point = np.where(rng.random(state.size) < 0.5, anywhere,
                     np.clip(near, 0, grid_size - 1))
    return state, point


@dataclass
class Request:
    """One call's atmosphere, and the output points the check reads."""
    atmosphere: Atmosphere
    state: np.ndarray
    point: np.ndarray


@dataclass
class Inputs:
    """The line lists and grid of a run, and its requests by index."""
    config: dict
    seed: int
    lines: dict
    grid: np.ndarray
    centers: np.ndarray

    def request(self, call):
        atm = atmosphere(self.config, self.seed, call)
        state, point = sample(self.config, self.seed, call, self.centers,
                              atm.num_states, self.grid.size)
        return Request(atmosphere=atm, state=state, point=point)

    def checked(self, calls):
        """Indices of the window's calls that the check compares: up to
        ``CHECKED_CALLS`` of its ``calls`` calls, drawn from the seed."""
        rng = np.random.default_rng([self.seed, 3000])
        return np.sort(rng.choice(calls, size=min(calls, CHECKED_CALLS),
                                  replace=False))


def make(config, seed):
    """The line lists and grid of a run of this configuration and seed."""
    lines = line_lists(config, seed)
    g = config["grid"]
    centers = np.concatenate([v["nu"] for v in lines.values()])
    centers = centers[(centers >= g["start"]) & (centers < g["stop"])]
    return Inputs(config=config, seed=seed, lines=lines,
                  grid=user_grid(config), centers=centers)
