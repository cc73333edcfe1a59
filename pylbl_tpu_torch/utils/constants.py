"""Physical constants shared across the framework.

Values intentionally match the reference implementation bit-for-bit so that
absorption spectra agree to round-off (see reference pyLBL/spectroscopy.py:15,
pyLBL/c_lib/spectra.c:12-15, pyLBL/mt_ckd/utils.py:7-13).
"""
import math

# Boltzmann constant [J K-1] (reference spectroscopy.py:15).
KB = 1.38064852e-23

# Speed of light [m s-1] (reference spectra.c:12).
VLIGHT = 2.99792458e8

# Pascal -> atmosphere conversion (reference spectra.c:13).
PA_TO_ATM = 9.86923e-6

# 2 * ln(2) * R, with R in [J kmol-1 K-1]; used for the Doppler half width
# (reference spectra.c:14).
R2 = 2.0 * math.log(2.0) * 8314.472

# Second radiation constant [cm K] (reference spectra.c:15, mt_ckd/utils.py:9).
C2 = 1.4387752

# Reference temperature for line parameters and TIPS [K] (reference tips.py:6).
T_REF = 296.0

# sqrt(ln 2) — converts HWHM to the Voigt y/x coordinates (reference voigt.c:8).
SQRT_LN2 = math.sqrt(math.log(2.0))

# 1/sqrt(pi) (reference voigt.c:7).
RSQRPI = 1.0 / math.sqrt(math.pi)

# MT-CKD constants (reference mt_ckd/utils.py:7-13).
LOSCHMIDT = 2.6867775e19  # Loschmidt constant [cm-3].
P0 = 1013.25              # Reference pressure (1 atm) [mb].
T0 = 296.0                # Reference temperature [K].
T273 = 273.15             # 0 Celsius [K].
M_TO_CM = 100.0           # [cm m-1].
PA_TO_MB = 0.01           # [mb Pa-1].

# Default wing cut-off distance from line centers [cm-1]
# (reference c_lib/gas_optics.py:47).
DEFAULT_CUT_OFF = 25
