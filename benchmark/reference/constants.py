"""Physical and dynamical constants (physical_constants.f90:16-29,
dynamical_constants.f90:12-23). Plain Python floats."""

REARTH = 6.371e6     # Earth radius (m)
OMEGA = 7.292e-5     # Earth rotation rate (rad/s)
GRAV = 9.81          # gravitational acceleration (m/s^2)

P0 = 1.0e5           # reference pressure (Pa)
CP = 1004.0          # specific heat at constant pressure (J/K/kg)
AKAP = 2.0 / 7.0     # R/cp for dry air
RGAS = AKAP * CP     # gas constant for dry air (J/K/kg)
ALHC = 2501.0        # latent heat of condensation (J/g: q is in g/kg)
ALHS = 2801.0        # latent heat of sublimation (J/g)
SBC = 5.67e-8        # Stefan-Boltzmann constant

GAMMA = 6.0          # reference lapse rate (K/km)
HSCALE = 7.5         # pressure scale height (km)
HSHUM = 2.5          # specific-humidity scale height (km)
REFRH1 = 0.7         # reference near-surface relative humidity
THD = 2.4            # del^6 diffusion damping time, T and vorticity (h)
THDD = 2.4           # del^6 diffusion damping time, divergence (h)
THDS = 12.0          # stratospheric del^2 diffusion damping time (h)
TDRS = 24.0 * 30.0   # stratospheric zonal-wind drag damping time (h)

# The reference's literal pi for the Gaussian-latitude seed
# (geometry.f90:68, legendre.f90:172); kept for bit-parity of the grid.
PI_F = 3.141592654
