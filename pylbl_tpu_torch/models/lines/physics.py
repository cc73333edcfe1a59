"""Per-line physics: strength scaling, broadening, window placement.

Vectorized (lines x layers) re-derivation of the reference's scalar per-line
physics (reference pyLBL/c_lib/spectra.c:8-62).  All formulas and constants
match the reference bit-for-bit; the difference is structural: the reference
computes these quantities one line at a time inside a sqlite cursor loop,
while here they are closed-form array expressions evaluated once per
(gas, layer batch) on the host in float64 (they are O(N_lines) and cheap;
the heavy O(N_lines x N_points) work happens in the device kernels).
"""
from dataclasses import dataclass, field

import numpy as np

from ...utils import constants as c
from ..tips import interp_uniform


@dataclass
class LinePack:
    """Device-ready structure-of-arrays for one molecule's line list.

    Arrays are sorted by ascending (raw) line position ``nu``, matching the
    processing order of the reference's sqlite cursor loop (reference
    absorption.c:76-87; HITRAN ingestion inserts transitions in ascending-nu
    order).  ``iso`` is the HITRAN local isotopologue id with the reference's
    "weird HITRAN counting" remap 0 -> 10 already applied (reference
    spectral_database.c:118-123, 173-177).
    """
    formula: str
    nu: np.ndarray           # [N] line position [cm-1].
    sw: np.ndarray           # [N] line intensity at 296 K [cm-1/(mol cm-2)].
    gamma_air: np.ndarray    # [N] air-broadened HWHM [cm-1 atm-1].
    gamma_self: np.ndarray   # [N] self-broadened HWHM [cm-1 atm-1].
    n_air: np.ndarray        # [N] temperature exponent.
    delta_air: np.ndarray    # [N] pressure shift [cm-1 atm-1].
    elower: np.ndarray       # [N] lower-state energy [cm-1].
    iso: np.ndarray          # [N] local isotopologue id (1-based, 0->10).
    mass_slots: np.ndarray   # [32] molar mass keyed by (isoid - 1).
    q_table: np.ndarray      # [n_iso, nT] TIPS rows in table insertion order.
    q_temperature: np.ndarray  # [nT] TIPS temperatures (uniform 1 K grid).
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        for name in ("nu", "sw", "gamma_air", "gamma_self", "n_air",
                     "delta_air", "elower"):
            setattr(self, name, np.ascontiguousarray(
                getattr(self, name), dtype=np.float64))
        self.iso = np.ascontiguousarray(self.iso, dtype=np.int64)
        self.mass_slots = np.ascontiguousarray(self.mass_slots,
                                               dtype=np.float64)
        self.q_table = np.ascontiguousarray(self.q_table, dtype=np.float64)
        self.q_temperature = np.ascontiguousarray(self.q_temperature,
                                                  dtype=np.float64)
        order = np.argsort(self.nu, kind="stable")
        if not np.array_equal(order, np.arange(order.size)):
            for name in ("nu", "sw", "gamma_air", "gamma_self", "n_air",
                         "delta_air", "elower", "iso"):
                setattr(self, name, getattr(self, name)[order])

    @property
    def num_lines(self):
        return self.nu.size

    _ARRAY_FIELDS = ("nu", "sw", "gamma_air", "gamma_self", "n_air",
                     "delta_air", "elower", "iso", "mass_slots", "q_table",
                     "q_temperature")

    @classmethod
    def load(cls, path):
        """Reads a pack saved by the JAX package's ``LinePack.save``."""
        with np.load(path, allow_pickle=False) as data:
            return cls(formula=str(data["formula"]),
                       **{name: data[name] for name in cls._ARRAY_FIELDS},
                       meta={"source": str(path)})

    @property
    def mass(self):
        """Per-line molar mass (reference spectral_database.c:178)."""
        return self.mass_slots[self.iso - 1]

    def q(self, temperature):
        """Per-line partition function Q(T) via the reference C interpolation
        (uniform 1 K table indexing, reference spectral_database.c:97-104).

        Interpolates once per isotopologue slot, then gathers per line —
        O(n_iso * nT + N) instead of materializing an [N, nT] table.

        Args:
            temperature: scalar or [B] array of temperatures.

        Returns:
            [N] or [B, N] array of Q values.
        """
        slot = np.clip(self.iso - 1, 0, self.q_table.shape[0] - 1)
        t = np.asarray(temperature, dtype=np.float64)
        if t.ndim == 0:
            q_slots = interp_uniform(self.q_temperature, self.q_table, t)
            return q_slots[slot]
        # [n_iso, B] -> gather lines -> [B, N].
        q_slots = interp_uniform(self.q_temperature,
                                 self.q_table[:, None, :], t[None, :])
        return q_slots[slot, :].T

    def compat_break_filter(self, v0, vn, cut_off):
        """Replicates the reference's sequential early-exit semantics.

        The reference's line loop ``break``s (not ``continue``s) at the first
        line outside [v0-(cut_off+1), vn+cut_off+1] (reference
        absorption.c:80-83), so every line *after* the first violation in
        processing order is dropped — including in-window ones.  Returns the
        slice bound to keep for bit-compatible behavior.
        """
        violation = (self.nu > vn + cut_off + 1) | (self.nu < v0 - (cut_off + 1))
        if not violation.any():
            return self.num_lines
        return int(np.argmax(violation))


def line_profile_params(pack, temperature, pressure, volume_mixing_ratio,
                        keep=None):
    """Computes the per-line lineshape parameters.

    Mirrors reference spectra.c:17-45 exactly, vectorized over lines and
    (optionally) a leading layer batch axis.

    Args:
        pack: LinePack.
        temperature: scalar or [B] temperature [K].
        pressure: scalar or [B] pressure [Pa].
        volume_mixing_ratio: scalar or [B] mole fraction [mol mol-1].
        keep: optional int, number of leading (nu-sorted) lines to use.

    Returns:
        dict of float64 arrays, each [N] or [B, N]:
            nu_shift: pressure-shifted line center [cm-1].
            gamma: Lorentz HWHM [cm-1].
            alpha: Doppler HWHM [cm-1].
            sw: effective line strength [m2 cm-1] (includes the 1e-4
                cm2 -> m2 factor, reference spectra.c:45).
    """
    sl = slice(None) if keep is None else slice(0, keep)
    nu = pack.nu[sl]
    t = np.asarray(temperature, dtype=np.float64)
    p = np.asarray(pressure, dtype=np.float64)
    vmr = np.asarray(volume_mixing_ratio, dtype=np.float64)
    batched = t.ndim > 0
    if batched:
        t, p, vmr = t[:, None], p[:, None], vmr[:, None]

    p_atm = p * c.PA_TO_ATM                       # spectra.c:17
    partial = p_atm * vmr                         # spectra.c:18
    tfact = 296.0 / t                             # spectra.c:19

    nu_shift = nu + p_atm * pack.delta_air[sl]    # spectra.c:22
    gamma = (pack.gamma_air[sl] * (p_atm - partial) +
             pack.gamma_self[sl] * partial) * tfact ** pack.n_air[sl]  # :25-26
    alpha = (nu / c.VLIGHT) * np.sqrt(c.R2 * t / pack.mass[sl])        # :29

    sb = np.exp(pack.elower[sl] * c.C2 * (t - 296.0) / (t * 296.0))    # :33
    g = np.exp((-c.C2 * nu) / t)                                       # :36
    gref = np.exp((-c.C2 * nu) / 296.0)                                # :37
    se = (1.0 - g) / (1.0 - gref)                                      # :38

    q_t = pack.q(temperature)[..., sl] if batched else pack.q(t)[sl]
    q_ref = pack.q(296.0)[sl]
    sq = q_ref / q_t                                                   # :41-42

    sw = pack.sw[sl] * sb * se * sq * 0.01 * 0.01                      # :45
    return {"nu_shift": nu_shift, "gamma": gamma, "alpha": alpha, "sw": sw}


def kernel_inputs(params, v0, n_per_v, cut_off):
    """Derives the arrays the summation kernels consume.

    Returns dict of float64/int64 arrays ([N] or [B, N]):
        center: (nu_shift - v0) * n_per_v, line center in grid-index units.
        repwid: sqrt(ln2)/alpha (reference voigt.c:13).
        y: Lorentz/Doppler ratio, repwid * gamma (reference voigt.c:14).
        prefactor: sw * rsqrpi * repwid (reference voigt.c:188).
        s_idx / e_idx: inclusive window bounds in grid-index units before
            clamping (reference spectra.c:48-62); the window is anchored at
            floor(nu_shift), i.e. integer-aligned.
    """
    nu_shift = params["nu_shift"]
    repwid = c.SQRT_LN2 / params["alpha"]
    y = repwid * params["gamma"]
    prefactor = params["sw"] * c.RSQRPI * repwid
    b = np.floor(nu_shift)
    s_idx = ((b - cut_off - v0) * n_per_v).astype(np.int64)
    e_idx = ((b + cut_off + 1 - v0) * n_per_v).astype(np.int64)
    center = (nu_shift - v0) * n_per_v
    return {"center": center, "repwid": repwid, "y": y,
            "prefactor": prefactor, "s_idx": s_idx, "e_idx": e_idx,
            "bucket": b.astype(np.int64)}
