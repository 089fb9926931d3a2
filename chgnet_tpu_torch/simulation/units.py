"""Physical constants for simulation in (eV, Angstrom, amu, fs, K, GPa).

Copy of ``chgnet_tpu.simulation.units`` (CODATA 2018 values, femtoseconds
as the time unit rather than ASE's derived unit of 10.180505 fs), so that
both packages integrate with the same numbers.
"""

from __future__ import annotations

# Boltzmann constant [eV / K]
KB = 8.617333262e-5

# 1 amu * (Angstrom / fs)^2 in eV: kinetic energy conversion for
# velocities in A/fs and masses in amu.
AMU_A2_FS2_TO_EV = 103.64269574711572

# acceleration [A/fs^2] = force [eV/A] / mass [amu] * EV_PER_AMU_A_TO_A_FS2
EV_PER_AMU_A_TO_A_FS2 = 1.0 / AMU_A2_FS2_TO_EV

# 1 GPa in eV / A^3 (= 1 / 160.21766208)
GPA_TO_EV_A3 = 1.0 / 160.21766208
EV_A3_TO_GPA = 160.21766208

# ASE's internal time unit (A * sqrt(amu / eV)) in fs, for reference
ASE_TIMEUNIT_FS = 10.180505710774743

# 1 atm in GPa (default MD pressure, dynamics.py:446)
ATM_IN_GPA = 1.01325e-4
