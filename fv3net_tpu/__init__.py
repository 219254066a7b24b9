"""fv3net_tpu: a JAX atmospheric modeling framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of ai2cm/fv3net:
an FV3-style cubed-sphere finite-volume dynamical core, the ML-coupling
runtime around it (time loop, steppers, diagnostics), an fv3fit-style ML
framework, and the vcm-style science utility library -- all built for
accelerator device meshes (sharding over cube faces with halo
collectives) rather than MPI domain decomposition.

Layout:
    grid/      cubed-sphere geometry, face topology, halo exchange
    ops/       numeric kernels (PPM reconstruction, vertical remap, fills)
    dycore/    the dynamical core (shallow-water + hydrostatic primitive eqs)
    physics/   column physics (simple physics suite, microphysics)
    parallel/  device-mesh partitioning, shard_map halo exchange
    runtime/   coupling time loop, steppers, diagnostics, wrapper API
    fit/       ML framework (Predictor contract, trainers, io registry)
    utils/     science utilities (thermo, coarsening, vertical interp)
    data/      data contracts (batch loading, mappers)
"""

__version__ = "0.1.0"
