"""Operations and bytes that the physics needs, counted from positions.

A kernel's roofline share is the least time its work could take on the card
over the time it took.  The work here is what the model's equations need at
the positions a frame holds, never what a kernel of the program walks: the
pairs within a potential's reach (not the candidates of a grid), each
bead's inputs read once and its outputs written once.  So the yardstick
stays put whatever a later change does to the grid, the stencil or the walk.

Operation counts a pair or a bead are written down from the formulas
(float32 adds, multiplies, compares; a square root, a reciprocal or a
division counts one):

- difference and squared distance: dx (3) and r2 = dx.dx (5): 8.
- A/B softcore pair force (potentials.ab_pair_force_coeff): the mixes
  (a_i + a_j)/2, (b_i + b_j)/2 (4); the p = 2, n = 3 term s = r2/d^2,
  1 - s, its square, times the constant (4); the p = 8, n = 3 term s, s^2,
  s^4, 1 - s^4, its square, s^3, two products (8); the mix (3); c dx (3)
  and the sum into both beads (6): 8 + 28 = 36.
- contact tick: r2 (8) and the compare (1): 9.
- mitotic softcore<2,3> repulsion: r2 (8), s, 1 - s, square, constant (4),
  c dx (3), both beads (6): 21.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
from scipy.spatial import cKDTree

PAIR_FORCE_OPS = 36
TICK_OPS = 9
MITOTIC_PAIR_OPS = 21
# Per bond: r2 (8), r = sqrt (1), the semispring's 1 - l/r and product (3),
# c dx (3), both beads (6).
BOND_OPS = 21
# Per bending triple: a, b (6), a.a, b.b, a.b (15), rsqrt of the product (2),
# two quotients (2), the two force vectors (12), three beads (9).
BENDING_OPS = 46
# Per kinetochore fiber or point source: dx (3), r2 (5), the spring (4),
# c dx (3), one bead (3).
SOURCE_OPS = 18
# Per bead and step of the Euler-Maruyama update: mu F dt + sigma xi + x (9).
UPDATE_OPS = 9
# Per bead of the rest of a G1 step: the wall's ray radius and signed
# distance (about 30 with the two square roots), its softcore or packing
# spring (12), the force along the gradient (12), the reaction sums (9).
WALL_OPS = 63

FLOAT = 4
# Bytes a bead: the pair force reads a position and the a/b factors and
# writes a force; the tick reads a position and writes 12 bytes a pair
# found; the rest of a G1 step reads the position, the pair force, the
# normals, the mobility, the a/b factors and a bond's spring and length,
# and writes the new position.
PAIR_FORCE_BYTES = (3 + 2 + 3) * FLOAT
TICK_BYTES = 3 * FLOAT
TICK_PAIR_BYTES = 3 * FLOAT
STEP_REST_BYTES = (3 + 3 + 3 + 1 + 2 + 2 + 3) * FLOAT


class Work(NamedTuple):
    flops: float
    bytes: float


def _replicas(x) -> np.ndarray:
    x = np.asarray(x, np.float64)
    return x.reshape(-1, *x.shape[-2:])


def pairs_within(x, reach: float) -> np.ndarray:
    """(P, 2) pairs i < j of one replica's positions (N, 3) closer than
    ``reach``, by a k-d tree."""
    return cKDTree(x).query_pairs(reach, output_type="ndarray")


def pair_force_pairs(x, af, bf, a_diameter: float, b_diameter: float) -> int:
    """Pairs within the A/B softcore's reach, over every replica of ``x``:
    the A term reaches ``a_diameter`` where the pair's A mix is not 0, the B
    term ``b_diameter`` where its B mix is not 0."""
    af, bf = np.asarray(af), np.asarray(bf)
    count = 0
    for xr in _replicas(x):
        p = pairs_within(xr, max(a_diameter, b_diameter))
        r2 = np.sum((xr[p[:, 0]] - xr[p[:, 1]]) ** 2, axis=1)
        a_on = (af[p[:, 0]] + af[p[:, 1]]) > 0
        b_on = (bf[p[:, 0]] + bf[p[:, 1]]) > 0
        count += int(np.sum((a_on & (r2 < a_diameter ** 2)) | (b_on & (r2 < b_diameter ** 2))))
    return count


def pair_force(x, af, bf, a_diameter: float, b_diameter: float) -> Work:
    """One pair-force launch over every replica of ``x``."""
    beads = _replicas(x).shape[0] * _replicas(x).shape[1]
    pairs = pair_force_pairs(x, af, bf, a_diameter, b_diameter)
    return Work(PAIR_FORCE_OPS * pairs, PAIR_FORCE_BYTES * beads)


def contact_tick(x, cutoff: float) -> Work:
    """One tick over every replica of ``x``: the pairs within ``cutoff``."""
    reps = _replicas(x)
    pairs = sum(len(pairs_within(xr, cutoff)) for xr in reps)
    return Work(TICK_OPS * pairs, TICK_BYTES * reps.shape[0] * reps.shape[1]
                + TICK_PAIR_BYTES * pairs)


def step_rest(beads: int, bonds: int, nucleolar_bonds: int) -> Work:
    """One launch of the rest of a G1 step over ``beads`` beads (all
    replicas): the bonds, the wall and the update."""
    return Work(BOND_OPS * (bonds + nucleolar_bonds) + (WALL_OPS + UPDATE_OPS) * beads,
                STEP_REST_BYTES * beads)


def mitotic_chunk(x, steps: int, diameter: float, bonds: int, triples: int,
                  sources: int) -> Work:
    """``steps`` mitotic steps from positions ``x`` (N, 3): the repulsion's
    pairs within ``diameter`` at these positions, the bonds (cohesion
    included), the bending triples and the fibers and point sources
    (``sources``, counted a bead each) every step; the normals read once,
    the positions and mobility read once and written once."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    pairs = len(pairs_within(x, diameter))
    per_step = (MITOTIC_PAIR_OPS * pairs + BOND_OPS * bonds + BENDING_OPS * triples
                + SOURCE_OPS * sources + UPDATE_OPS * n)
    return Work(per_step * steps, FLOAT * (3 * n * steps + 3 * n + n + 3 * n))


def peaks(kind: str):
    """(float32 FLOP/s, bytes/s) of the card ``kind`` from ``peaks.json``,
    or None for a card the table does not hold."""
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
        table = json.load(f)["cards"]
    entry = table.get(kind)
    return None if entry is None else (entry["float32_flops"], entry["bytes_per_s"])


def least_seconds(work: Work, kind: str):
    """The least time ``work`` can take on the card ``kind``: the larger of
    its operations over the float32 peak and its bytes over the memory
    bandwidth; None for a card the table does not hold."""
    peak = peaks(kind)
    if peak is None:
        return None
    return max(work.flops / peak[0], work.bytes / peak[1])
