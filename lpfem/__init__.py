"""lpfem — linear potential-flow FEM framework in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
``hirschjulien/Master-Thesis-LPF-in-MFEM`` (an MFEM/hypre/MPI linear
potential-flow free-surface wave solver): high-order spectral elements,
matrix-free partial assembly, jitted preconditioned CG, free-surface RK4
time stepping, relaxation zones, wave-cylinder diffraction, and
device-mesh sharding with XLA collectives in place of MPI.

Layering (see SURVEY.md §7):
    mesh      host NumPy hex meshes (Cartesian, periodic, refine, parsers)
    elements  GLL Lagrange basis / quadrature tables
    space     topological H1 dof numbering, boundary + surface trace maps
    operators matrix-free Laplace PA (separable lattice, fused, sum-
              factorized), norms
    solvers   jitted PCG + preconditioners
    surface   free-surface RHS, relaxation zones (the reference's rhs_linear)
    timestep  RK4 via lax.scan
    shard     device-mesh domain decomposition (shard_map + collectives)
    analytic  Airy waves, dispersion, McCamy-Fuchs
    io        ParaView VTU writer, data files, checkpoints
    configs   presets reproducing each reference program
"""

import os

import jax

# MFEM runs double precision throughout; CG tolerances down to 1e-24 (on the
# squared residual) require f64 scalars. Opt out with LPFEM_X64=0 (the
# float32 / mixed paths use explicit f32 arrays either way).
if os.environ.get("LPFEM_X64", "1") != "0":
    jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: RK4-scan programs take tens of seconds
# to compile. JAX reads JAX_COMPILATION_CACHE_DIR itself when it is set;
# otherwise the cache lives at a fixed path inside the checkout (the path
# is part of the cache key). Opt out with LPFEM_NO_COMPILE_CACHE=1.
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")
if not os.environ.get("LPFEM_NO_COMPILE_CACHE") \
        and not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)

from . import analytic, elements, mesh, operators, solvers, space, surface, timestep  # noqa: E402,F401

__version__ = "0.1.0"
