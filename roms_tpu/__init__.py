"""roms_tpu: a regional ocean dynamical core in JAX, compiled by XLA.

Built from scratch with the capabilities of ROMS 3.9 (the reference at
joaobuibergen/roms-trunk-mgh): free-surface, hydrostatic primitive equations
on terrain-following s-coordinates, Arakawa C-grid, split-explicit LF-AM3
time stepping.  See SURVEY.md for the reference analysis and build plan.
"""

from .config import Config, LBC
from .grid import Grid, build_grid, build_spherical_grid, build_weights

__version__ = "0.1.0"
