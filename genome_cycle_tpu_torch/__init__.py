"""genome_cycle_tpu_torch — PyTorch/CUDA port of the whole-genome cell-cycle
Brownian-dynamics framework in :mod:`genome_cycle_tpu`.

The JAX package beside this one is the reference; this package imports
``torch``, never ``jax`` and nothing of the JAX package.  Ported so far: the
whole cell cycle on one device (prepare -> anaphase + telophase -> transition
interphase -> relaxation + G1 -> transition prometaphase -> prometaphase ->
transition cycle into the next cell), as the commands ``simulate`` and
``cycles`` chain it, the interphase of an ensemble of replicas in
lock-step on one device (``ensemble``), the multi-device drivers on
``torch.distributed`` (G1 decomposed over ranks, ``interphase --shards``;
replicas spread over ranks), and the analysis tools, with the contact-map
and compartment numerics on the device.  Not ported yet: the bench.

Layout (same module and function names as the JAX package):

- :mod:`genome_cycle_tpu_torch.config`    — JSON config (reference-compatible schema)
- :mod:`genome_cycle_tpu_torch.topology`  — chains.tsv parsing + topology compiler
- :mod:`genome_cycle_tpu_torch.store`     — HDF5 trajectory store + in-memory twin
- :mod:`genome_cycle_tpu_torch.ops`       — potentials, bonded, bending,
  fiber and wall forces, BD integrator, the A/B pair-force CUDA kernel and its
  plain version, contact search and window merge
- :mod:`genome_cycle_tpu_torch.models`    — prepare, transitions, anatelophase,
  interphase, prometaphase
- :mod:`genome_cycle_tpu_torch.parallel`  — the ensemble of replicas, the
  process group and mesh of ranks, the halo and replicated-position engines
- :mod:`genome_cycle_tpu_torch.analysis`  — cool, dephase, pc1 (on the device),
  nci, annotate, dumpgsd and their helpers
- :mod:`genome_cycle_tpu_torch.convert`   — model/state from numpy arrays
- :mod:`genome_cycle_tpu_torch.utils`     — splines, logging, the spans and
  counters of ``utils/tracing.py``
"""

__version__ = "0.1.0"


def default_device():
    """The device every entry point runs on unless the caller names one:
    the first CUDA card.  Raises when there is none — a run never carries
    on silently on the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU explicitly"
        )
    return torch.device("cuda")


def resolve_device(device=None):
    """``None`` -> :func:`default_device`; anything else -> ``torch.device``."""
    import torch

    if device is None:
        return default_device()
    return torch.device(device)
