"""porousfreezethaw — a JAX scientific computing framework.

A JAX / XLA framework with the capabilities of the
reference C/MPI/OpenMP suite ``radixsorth/PorousFreezeThaw``:

* a 3-D finite-volume phase-field + heat-equation simulator of water
  freezing/thawing in porous media (``intertrack`` — reference
  ``apps/intertrack-hybrid-S-freezing``), and
* a DEM simulator of spherical-particle settling with a soft contact model
  (``spheres`` — reference ``apps/sphere-collider``),

both driven by an adaptive Runge-Kutta-Merson time integrator (reference
``modules/RK_Asolver`` / ``RK_MPI_SAsolver`` family).

Instead of slab MPI decomposition + ghost-cell exchange + OpenMP loops, this
framework shards the grid over a device mesh (``jax.sharding``), lets XLA
insert collectives for halo exchange and error reduction, and vectorizes
the DEM contact pipeline.  Everything is plain ``jax.numpy``/``lax`` that
XLA compiles for the GPU (or the CPU, for tests).

Subpackages
-----------
core      precision policy, grid geometry, compile cache and device record
config    Params configuration language (expression evaluator, parameter files,
          $ENV substitution, batch sweeps) — reference libsource/exprsion,
          modules/{pparser,cparser,evsubst}
solvers   time integrators: fixed RK4 and adaptive Runge-Kutta-Merson
parallel  device mesh setup, sharding specs, explicit halo exchange
models    freezing (phase-field/heat) and DEM force models
io        NetCDF snapshots & checkpoint/resume, CSV snapshots, exporters
apps      command-line applications: intertrack, spheres
"""

__version__ = "0.1.0"
