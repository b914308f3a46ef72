"""Analysis & IO toolchain of the port: Hi-C input prep, contact-map
export, compartment profiles, visualization dumps.

Module for module the counterpart of ``genome_cycle_tpu.analysis``.  The
contact-map and compartment numerics (``coolio``, ``cool``, ``dephase``,
``pc1``) run on a torch device; ``nci``, ``annotate``, ``cyto``, ``gsdio``,
``dumpgsd`` and ``common`` are host code, copies of the JAX package's
modules.  No module imports ``h5py`` until it opens a file.
"""
