"""Prepare stage: compile inputs into a fresh trajectory store.

Equivalent of the reference ``prepare`` binary
(stage_prepare/main.cpp:46-163): config.json + chains.tsv + master seed ->
new store (an HDF5 file, or a :class:`~..store.MemoryStore` handed in) with all
metadata, topology and derived stage seeds.
"""

from __future__ import annotations

import secrets
from typing import Optional

from ..config import parse_config
from ..store import prepare_store
from ..topology import compile_topology, load_chains


def run_prepare(
    output,
    config_path: str,
    chains_path: str,
    seed: Optional[int] = None,
    log=print,
):
    with open(config_path) as f:
        config = parse_config(f.read())
    chains = load_chains(chains_path)
    topology = compile_topology(chains, config)
    if seed is None:
        # Reference uses std::random_device when no seed is given
        # (stage_prepare/main.cpp:154-163).
        seed = secrets.randbits(32)
    prepare_store(output, config, chains, topology, master_seed=int(seed))
    n = len(topology.interphase.particle_types)
    name = output if isinstance(output, str) else type(output).__name__
    log(
        f"prepared {name}: {len(chains.chains)} chains, {n} interphase "
        f"particles, {len(topology.anatelophase.particle_types)} mitotic beads, "
        f"master seed {seed}"
    )
    return seed
