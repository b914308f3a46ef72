"""Dense O(N^2) pair forces.

The brute path of the pair force below ``brute_force_threshold``, the
nucleolar droplet force over its few targets, and the layout-free oracle the
pair-force kernel is tested against.  Evaluated in row blocks, so the (rows,
N) temporaries stay bounded and the function also runs at the production
nucleus' 59,610 beads.
"""

from __future__ import annotations

import torch

# Pair-matrix elements per row block (a few f32 temporaries of this size live
# at once).
_BLOCK_ELEMENTS = 1 << 24


def pairwise_forces_dense(positions, coeff_fn, energy_fn=None, targets=None):
    """O(N^2) masked pairwise forces.

    ``coeff_fn(r2, i, j)`` returns c with F_i += c * (x_i - x_j); ``i`` and
    ``j`` are broadcastable index tensors (rows, 1) and (1, m).  ``targets``
    optionally restricts interactions to a subset of particle indices
    (micromd ``set_neighbor_targets``, used by the nucleolar droplet force).
    ``positions`` (R, N, 3) holds R replicas of one topology, each on its
    own: pairs never join two replicas, and the energy is summed over all.
    Returns (forces of the positions' shape, energy); energy is 0 without
    ``energy_fn``.
    """
    n = positions.shape[-2]
    device = positions.device
    if targets is not None:
        ids = torch.as_tensor(targets, dtype=torch.long, device=device)
        pos = positions[..., ids, :]
    else:
        ids = torch.arange(n, dtype=torch.long, device=device)
        pos = positions
    m = pos.shape[-2]
    batch = pos.numel() // max(3 * m, 1)
    energy = positions.new_zeros(())
    f = torch.zeros_like(pos)
    rows = max(1, min(m, _BLOCK_ELEMENTS // max(m * batch, 1)))
    far = torch.full((), 1e30, dtype=positions.dtype, device=device)   # no host copy
    for r0 in range(0, m, rows):
        r1 = min(r0 + rows, m)
        dx = pos[..., r0:r1, None, :] - pos[..., None, :, :]     # (..., rows, m, 3)
        r2 = torch.sum(dx * dx, dim=-1)
        valid = ids[r0:r1, None] != ids[None, :]
        r2 = torch.where(valid, r2, far)
        c = coeff_fn(r2, ids[r0:r1, None], ids[None, :])
        c = torch.where(valid, c, torch.zeros_like(c))
        f[..., r0:r1, :] = torch.sum(c[..., None] * dx, dim=-2)
        if energy_fn is not None:
            u = energy_fn(r2, ids[r0:r1, None], ids[None, :])
            energy = energy + 0.5 * torch.sum(
                torch.where(valid, u, torch.zeros_like(u))
            )
    if targets is not None:
        forces = torch.zeros_like(positions).index_add_(-2, ids, f)
    else:
        forces = f
    return forces, energy
