"""CSG intersection filtering, data-parallel.

The reference filters a sorted intersection list through a sequential
state machine per CSG node (csg.rs:51-72): walking hits in t-order while
toggling in_l/in_r and keeping hits the op's truth table allows
(csg.rs:117-123). Nested trees recurse: a child node filters its own hits
before the parent ever sees them (csg.rs:26-49).

Batched replacement: in_l/in_r *before* hit j are parities of how many
earlier (alive, in-subtree) hits were left/right hits — i.e. exclusive
prefix sums mod 2 over the t-sorted candidate list. Processing nodes
bottom-up with an "alive" mask reproduces the recursion exactly, with no
sequential scan: every node is two cumsums and a truth-table select.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from raytracer_tpu.core import types as T


def _op_allowed(op_code, l_hit, in_l, in_r):
    """csg.rs:117-123 truth table (vectorized)."""
    union = (l_hit & ~in_r) | (~l_hit & ~in_l)
    inter = (l_hit & in_r) | (~l_hit & in_l)
    diff = (l_hit & ~in_r) | (~l_hit & in_l)
    return {T.CSG_UNION: union, T.CSG_INTERSECT: inter, T.CSG_DIFFERENCE: diff}[op_code]


# Column count above which the sorted-cumsum path beats the O(C^2)
# pairwise parity (mesh-bearing CSG trees); below it the sortless path
# avoids the sort entirely.
PAIRWISE_MAX_COLS = 128


def apply_csg(scene: T.Scene, ts, static_gids: np.ndarray, c_static: int):
    """Set t=+inf for candidate intersections disallowed by CSG rules.

    ``ts`` is [R, C]; only the first ``c_static`` columns (static gids) can
    belong to CSG trees. Returns the filtered ts.

    The alive-mask recursion is per-COLUMN (a node only rewrites its own
    subtree's columns), so nothing here needs the hits in t-order: the
    in_l/in_r parities before hit j are parities of *counts of earlier
    hits*, i.e. lexicographic (t, column) pairwise comparisons. Small
    trees (every sample scene) take the sortless pairwise path — two
    fused [R, Cr, Cr] count-reductions per node, no argsort, no gathers,
    no scatter-back; wide trees (CSG over meshes: hundreds of triangle
    columns) fall back to argsort + exclusive prefix parity, where the
    O(Cr^2) pairwise term would dominate.
    """
    st = scene.static
    if not st.csg_nodes:
        return ts

    member = {gid: (under, left) for gid, under, left in st.csg_members}
    roots = sorted({root for _, _, root in st.csg_nodes})

    for root in roots:
        root_mask = 1 << root
        cols = [
            j for j in range(len(static_gids))
            if member.get(int(static_gids[j]), (0, 0))[0] & root_mask
        ]
        if not cols:
            continue
        cols = np.asarray(cols)
        under_bits = np.array(
            [member[int(static_gids[j])][0] for j in cols], np.uint64
        )
        left_bits = np.array(
            [member[int(static_gids[j])][1] for j in cols], np.uint64
        )
        nodes = [n for n in st.csg_nodes if n[2] == root]

        sub = ts[:, cols]                               # [R, Cr]
        if len(cols) <= PAIRWISE_MAX_COLS:
            new_sub = _filter_pairwise(
                sub, nodes, under_bits, left_bits
            )
        else:
            new_sub = _filter_sorted(sub, nodes, under_bits, left_bits)
        ts = ts.at[:, cols].set(new_sub)

    return ts


def _filter_pairwise(sub, nodes, under_bits, left_bits):
    """Sortless node loop: count-of-earlier-hits parities via pairwise
    lexicographic (t, column) comparisons, fused into two [R, Cr, Cr]
    reductions per node (the comparison tensor is never re-ordered, so
    ties break by column index exactly like the stable argsort)."""
    c = sub.shape[-1]
    alive = jnp.isfinite(sub)
    # earlier[i, j]: hit i strictly precedes hit j in the sorted order
    tie = jnp.asarray(
        np.tril(np.ones((c, c), np.bool_), -1).T  # i < j
    )
    earlier = (sub[:, :, None] < sub[:, None, :]) | (
        (sub[:, :, None] == sub[:, None, :]) & tie[None]
    )                                               # [R, Cr, Cr]

    for op_code, bit, _ in nodes:
        under_n = jnp.asarray((under_bits >> bit) & 1, jnp.bool_)[None]
        l_hit = jnp.asarray((left_bits >> bit) & 1, jnp.bool_)[None]
        relevant = under_n & alive                  # [R, Cr]
        inc_l = relevant & l_hit
        inc_r = relevant & ~l_hit
        cnt_l = jnp.sum(
            (inc_l[:, :, None] & earlier).astype(jnp.int32), axis=1
        )
        cnt_r = jnp.sum(
            (inc_r[:, :, None] & earlier).astype(jnp.int32), axis=1
        )
        in_l = (cnt_l % 2) == 1
        in_r = (cnt_r % 2) == 1
        allowed = _op_allowed(op_code, l_hit, in_l, in_r)
        alive = jnp.where(relevant, allowed, alive)

    return jnp.where(alive, sub, jnp.inf)


def _filter_sorted(sub, nodes, under_bits, left_bits):
    """argsort + exclusive-prefix parity (the wide-tree fallback)."""
    order = jnp.argsort(sub, axis=-1)
    sub_sorted = jnp.take_along_axis(sub, order, -1)
    alive = jnp.isfinite(sub_sorted)

    for op_code, bit, _ in nodes:
        under_n = jnp.take(
            jnp.asarray((under_bits >> bit) & 1, jnp.bool_), order
        )
        l_hit = jnp.take(
            jnp.asarray((left_bits >> bit) & 1, jnp.bool_), order
        )
        relevant = under_n & alive
        inc_l = (relevant & l_hit).astype(jnp.int32)
        inc_r = (relevant & ~l_hit).astype(jnp.int32)
        # exclusive prefix: state BEFORE processing hit j
        in_l = ((jnp.cumsum(inc_l, -1) - inc_l) % 2) == 1
        in_r = ((jnp.cumsum(inc_r, -1) - inc_r) % 2) == 1
        allowed = _op_allowed(op_code, l_hit, in_l, in_r)
        alive = jnp.where(relevant, allowed, alive)

    filtered = jnp.where(alive, sub_sorted, jnp.inf)
    # scatter back through the inverse permutation
    inv_order = jnp.argsort(order, axis=-1)
    return jnp.take_along_axis(filtered, inv_order, -1)
