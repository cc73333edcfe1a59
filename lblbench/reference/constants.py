"""Physical constants of the reference pyLBL (GRIPS-code/pyLBL:
spectroscopy.py, c_lib/spectra.c, c_lib/voigt.c, mt_ckd/utils.py), which
the program under test reproduces."""
import math

KB = 1.38064852e-23           # Boltzmann constant [J K-1].
VLIGHT = 2.99792458e8         # speed of light [m s-1].
PA_TO_ATM = 9.86923e-6        # [atm Pa-1].
R2 = 2.0 * math.log(2.0) * 8314.472  # 2 ln2 R [J kmol-1 K-1].
C2 = 1.4387752                # second radiation constant [cm K].
T_REF = 296.0                 # line-parameter reference temperature [K].
SQRT_LN2 = math.sqrt(math.log(2.0))
RSQRPI = 1.0 / math.sqrt(math.pi)
LOSCHMIDT = 2.6867775e19      # [cm-3].
P0 = 1013.25                  # [mb].
T0 = 296.0                    # MT-CKD reference temperature [K].
T273 = 273.15                 # [K].
M_TO_CM = 100.0               # [cm m-1].
PA_TO_MB = 0.01               # [mb Pa-1].
