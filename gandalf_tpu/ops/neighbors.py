"""Neighbour machinery: ghost images and (for now) all-pairs interaction.

The reference builds explicit ghost-particle arrays + KD trees per step
(src/Hydrodynamics/Ghosts.cpp, src/Tree/*).  The vectorised formulation:

- **periodic** boundaries need no ghosts at all — the minimum-image
  convention is applied inside the displacement computation
  (``DomainBox.min_image``), a fused vector op.
- **mirror/wall** boundaries are handled by statically-shaped reflected
  *image views* of the whole particle set; images beyond kernel range
  contribute exactly zero through the compact kernel, so no pruning or
  dynamic allocation is needed for correctness.  (The production cell-list
  path prunes them for speed.)

The all-pairs (N x M) "brute force" path here is both the small-N fast path
and the correctness oracle for the tree/cell-list paths, mirroring the role
of the reference's BruteForceTree (src/Tree/BruteForceTree.cpp).
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp

from ..state import DomainBox

Array = jnp.ndarray


def mirror_image_count(box: DomainBox) -> int:
    """Number of whole-set image copies (1 original + 1 per mirror wall)."""
    return 1 + len(box.mirror_walls())


def extend_with_mirror_images(
    box: DomainBox, r: Array, v: Array, scalars: Dict[str, Array]
) -> Tuple[Array, Array, Dict[str, Array], Array]:
    """Concatenate mirror-image copies of all particles.

    Returns (r_ext, v_ext, scalars_ext, parent_idx).  For each mirror/wall
    boundary (dim k, side), the image has r'_k = 2*bound - r_k and v'_k
    = -v_k (reference reflect() helpers, src/Headers/Particle.h:601-668);
    every other field copies the parent.
    """
    walls = box.mirror_walls()
    N = r.shape[0]
    parent = jnp.arange(N, dtype=jnp.int32)
    rs, vs, parents = [r], [v], [parent]
    for (k, side) in walls:
        bound = box.boxmin[k] if side == 0 else box.boxmax[k]
        r_img = r.at[:, k].set(2.0 * bound - r[:, k])
        v_img = v.at[:, k].set(-v[:, k])
        rs.append(r_img)
        vs.append(v_img)
        parents.append(parent)
    r_ext = jnp.concatenate(rs, axis=0)
    v_ext = jnp.concatenate(vs, axis=0)
    parent_ext = jnp.concatenate(parents, axis=0)
    n_img = len(walls) + 1
    scalars_ext = {k: jnp.tile(a, (n_img,)) for k, a in scalars.items()}
    return r_ext, v_ext, scalars_ext, parent_ext


def pair_displacements(box: DomainBox, ri: Array, rj: Array) -> Array:
    """All-pairs displacement r_j - r_i with periodic min-image: (N, M, ndim)."""
    dr = rj[None, :, :] - ri[:, None, :]
    return box.min_image(dr)
