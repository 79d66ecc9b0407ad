"""Matrix operations with the book's vocabulary (reference src/matrices.rs).

The engine itself uses batched jnp matmuls/inverses; these named helpers
(submatrix/minor/cofactor/determinant/adjugate inverse) exist for the
library API and the book-oracle tests. Differentiable; any square size.
"""

from __future__ import annotations

import jax.numpy as jnp


def identity(n: int = 4):
    return jnp.eye(n)


def transpose(m):
    return jnp.asarray(m).T


def submatrix(m, row: int, col: int):
    """matrices.rs:100-118: drop one row and one column."""
    m = jnp.asarray(m)
    m = jnp.delete(m, row, axis=0)
    return jnp.delete(m, col, axis=1)


def minor(m, row: int, col: int):
    """matrices.rs:120-126."""
    return determinant(submatrix(m, row, col))


def cofactor(m, row: int, col: int):
    """matrices.rs:128-137: minor with checkerboard sign."""
    sign = -1.0 if (row + col) % 2 else 1.0
    return sign * minor(m, row, col)


def determinant(m):
    """matrices.rs:139-183 (cofactor expansion semantics; computed
    directly for speed and differentiability)."""
    m = jnp.asarray(m)
    if m.shape[-1] == 1:
        return m[..., 0, 0]
    if m.shape[-1] == 2:
        return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    return jnp.linalg.det(m)


def is_invertible(m):
    return bool(determinant(m) != 0.0)


def inverse(m):
    """matrices.rs:185-198 (adjugate inverse semantics)."""
    return jnp.linalg.inv(jnp.asarray(m))


def mat_mul_tuple(m, t):
    """Matrix x 4-tuple (matrices.rs:200-236)."""
    return jnp.matmul(jnp.asarray(m), jnp.asarray(t), precision="highest")
