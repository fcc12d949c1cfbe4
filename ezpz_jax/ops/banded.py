"""Banded SPD Cholesky factor/solve via ``lax.scan``.

Chain-like coupled systems produce a boundary Schur complement whose
graph is (block-)tridiagonal: part p's boundary variables couple only to
parts p-1 / p+1, so under the natural boundary ordering the matrix has
half-bandwidth ``bw`` = a few interface widths. The reference serves
these systems through its general sparse LLT (`newton.rs:87-102`), whose
fill-in on a banded matrix IS the band — this module is the batched
equivalent: a fixed-band factorization with static shapes.

Cost: O(n * bw^2) flops and 3n sequential scan steps (factor + two
substitutions) instead of the dense O(n^3) Cholesky or ~sqrt(cond(S))
preconditioned-CG matvecs. Each scan step is a (bw,)- or (bw, bw)-shaped
vector op, so a ``vmap`` over a solve batch turns the steps into
(B, bw)-wide elementwise work — sequential in n but fully vectorized across the
batch, which is exactly the coupled-fleet regime (`parallel/block_schur`).

Storage: LOWER band, ``Ab[i, d] = A[i, i - bw + d]`` for
``d in [0, bw]`` (so ``Ab[i, bw]`` is the diagonal); entries that fall
off the left edge are zero. The factor uses the same layout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Bandwidth ceiling for routing a topology's PER-SKETCH normal equations
# through the band factorization (see plan_band): the scan body unrolls
# O(bw^2) vector ops per step, so the traced program grows quadratically
# in bw; 32 keeps it tractable while covering every chain/grid fixture
# (chains order to bw 7, a 10x10 grid to ~23).
BANDED_MAX_BW = 32


def banded_cholesky(Ab: jnp.ndarray):
    """Factor an SPD banded matrix given as a lower band.

    ``Ab``: (n, bw+1) lower band (see module docstring). Returns
    ``(Lb, fail)`` with the same layout (``Lb[i, bw]`` = diagonal of L)
    and a scalar bool ``fail`` set when a pivot is non-finite or
    non-positive (numerically non-SPD); the factor is zero-diagonal-safe
    to substitute with (pivots sanitized to 1.0) so callers can discard
    the result exactly like ``ops.linalg.spd_solve``.
    """
    n, bwp1 = Ab.shape
    bw = bwp1 - 1

    def step(window, a_row):
        # window: (bw, bw+1) — band rows of L for rows i-bw..i-1, aligned
        # so window[k, d] = L[i-bw+k, (i-bw+k) - bw + d].
        # Row i of L: for each d in [0, bw): column j = i - bw + d,
        #   L[i, j] = (A[i, j] - sum_{k < j, j-k <= bw} L[i,k] L[j,k]) / L[j,j]
        # computed in increasing d (a serial bw-length chain, unrolled at
        # trace time — bw is small and static).
        row = jnp.zeros((bwp1,), Ab.dtype)
        for d in range(bw):
            # Row j = i - bw + d lives at window[d]. Align the already-
            # computed entries of row i (columns i-bw .. i-bw+d-1) with
            # row j's band (columns j-bw .. j): row i's column (i-bw+t)
            # sits at position t; in row j's band it sits at
            # (i-bw+t) - (j-bw) = t - d + bw.
            s = jnp.zeros((), Ab.dtype)
            for t in range(d):
                s = s + row[t] * window[d, t - d + bw]
            pivot = window[d, bw]
            row = row.at[d].set((a_row[d] - s) / pivot)
        s = jnp.sum(row[:bw] * row[:bw])
        diag2 = a_row[bw] - s
        bad = ~(diag2 > 0) | ~jnp.isfinite(diag2)
        diag = jnp.where(bad, 1.0, jnp.sqrt(jnp.where(bad, 1.0, diag2)))
        row = row.at[bw].set(diag)
        new_window = jnp.concatenate([window, row[None, :]], axis=0)[1:]
        return new_window, (row, bad)

    # Virtual rows above the top: identity diagonal, zero off-band —
    # matches the zero padding of Ab's left edge, so the first real rows
    # divide by 1.0 and subtract 0.0 for out-of-range terms.
    w0 = jnp.zeros((bw, bwp1), Ab.dtype).at[:, bw].set(1.0)
    _, (Lb, bads) = jax.lax.scan(step, w0, Ab)
    return Lb, jnp.any(bads)


def banded_solve(Lb: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve L L^T x = b given the lower-band factor from
    ``banded_cholesky``. ``b``: (n,) or (n, m)."""
    n, bwp1 = Lb.shape
    bw = bwp1 - 1
    vec = b.ndim == 1
    r = b[:, None] if vec else b
    m = r.shape[1]

    # Forward: y[i] = (b[i] - sum_{d<bw} L[i, i-bw+d] y[i-bw+d]) / L[i,i].
    def fwd(carry, inp):
        lrow, bi = inp  # (bw+1,), (m,)
        s = jnp.einsum("d,dm->m", lrow[:bw], carry,
                       precision=jax.lax.Precision.HIGHEST)
        yi = (bi - s) / lrow[bw]
        return jnp.concatenate([carry, yi[None, :]], axis=0)[1:], yi

    _, y = jax.lax.scan(fwd, jnp.zeros((bw, m), Lb.dtype), (Lb, r))

    # Backward with L^T: x[i] = (y[i] - sum_{t=1..bw} L[i+t, i] x[i+t])
    #                           / L[i, i].
    # Row i+t's entry for column i sits at band position bw - t. Scan in
    # reverse carrying the NEXT bw solutions x[i+1..i+bw] (newest first)
    # and the corresponding band rows.
    def bwd(carry, inp):
        xs, lrows = carry  # (bw, m), (bw, bw+1): rows i+1..i+bw
        lrow, yi = inp
        s = jnp.zeros((m,), Lb.dtype)
        for t in range(1, bw + 1):
            s = s + lrows[t - 1, bw - t] * xs[t - 1]
        xi = (yi - s) / lrow[bw]
        xs = jnp.concatenate([xi[None, :], xs], axis=0)[:bw]
        lrows = jnp.concatenate([lrow[None, :], lrows], axis=0)[:bw]
        return (xs, lrows), xi

    carry0 = (
        jnp.zeros((bw, m), Lb.dtype),
        jnp.zeros((bw, bwp1), Lb.dtype).at[:, bw].set(1.0),
    )
    _, x_rev = jax.lax.scan(bwd, carry0, (Lb, y), reverse=True)
    x = x_rev
    return x[:, 0] if vec else x


def banded_spd_solve(Ab: jnp.ndarray, b: jnp.ndarray):
    """``spd_solve`` interface for a banded matrix: returns ``(x, fail)``
    with x zero-filled on failure."""
    Lb, fail = banded_cholesky(Ab)
    x = banded_solve(Lb, b)
    return jnp.where(fail, jnp.zeros_like(x), x), fail


def _jtj_pattern(instances, n):
    """Lower-triangular nonzero pattern {(i, j), i >= j} of JtJ from the
    static instance variable ids (``instances``: records whose index 1 is
    the instance's variable-id list). The diagonal is always present (the
    LM damping lands there)."""
    pat = {(i, i) for i in range(n)}
    for inst in instances:
        ids = inst[1]
        for a in ids:
            for b in ids:
                if a >= b:
                    pat.add((a, b))
    return pat


def _rcm_order(pat, n):
    """Reverse Cuthill-McKee ordering of the JtJ adjacency graph. Returns
    ``perm`` (position k holds the original variable index eliminated
    k-th). Classic bandwidth-reducing heuristic: BFS from a minimum-degree
    vertex per component, neighbors visited in increasing-degree order,
    then reverse."""
    adj = [set() for _ in range(n)]
    for i, j in pat:
        if i != j:
            adj[i].add(j)
            adj[j].add(i)
    deg = [len(a) for a in adj]
    visited = [False] * n
    order = []
    for start in sorted(range(n), key=lambda v: (deg[v], v)):
        if visited[start]:
            continue
        visited[start] = True
        queue = [start]
        qi = 0
        while qi < len(queue):
            v = queue[qi]
            qi += 1
            order.append(v)
            for w in sorted(adj[v], key=lambda u: (deg[u], u)):
                if not visited[w]:
                    visited[w] = True
                    queue.append(w)
    order.reverse()
    return order


def plan_band(system):
    """Bandwidth plan for a topology's damped normal equations: the
    narrowest half-bandwidth achievable by the identity or RCM ordering
    of the JtJ graph, or None when no ordering is narrow enough for the
    band tier to beat the dense one.

    Returns ``(perm, bw)`` with ``perm`` a numpy elimination order
    (position k holds the original variable eliminated k-th; None =
    identity). Without it, a 146-var chain's normal matrix would go to a
    DENSE Cholesky even though its RCM band is 7 wide — the reference's
    sparse LLT (``newton.rs:87-102``, fill-in on a banded matrix IS the
    band) never pays that. The band tier keeps the cost size-robust:
    O(n*bw^2) work and 3n scan steps, fully vectorized across a vmapped
    batch."""
    n = system.n_vars
    ids_list = [
        (None, [int(j) for j in b.idx[i]])
        for b in system.blocks
        for i in range(b.idx.shape[0])
    ]
    if not ids_list or n == 0:
        return None
    pat = _jtj_pattern(ids_list, n)
    best_bw = max((i - j for (i, j) in pat))
    best_perm = None
    rcm = _rcm_order(pat, n)
    inv = [0] * n
    for k, v in enumerate(rcm):
        inv[v] = k
    bw_rcm = max((abs(inv[i] - inv[j]) for (i, j) in pat))
    if bw_rcm < best_bw:
        best_bw, best_perm = bw_rcm, rcm
    if best_bw > BANDED_MAX_BW or best_bw + 1 >= n // 2:
        return None
    return (None if best_perm is None else np.asarray(best_perm)), best_bw


def make_banded_spd(n: int, bw: int, perm=None):
    """Build an ``spd(A, b) -> (x, fail)`` (the ``ops.linalg.spd_solve``
    contract) that permutes the dense damped normal matrix into its
    ``bw``-wide lower band and solves via the scan factorization.

    ``A`` arrives dense ((n, n), assembled by segment-sum — entries
    outside the JtJ pattern are exact zeros, so the band extraction is
    lossless by construction of ``plan_band``); everything here is
    elementwise/gather, so a ``vmap`` over a solve batch turns the 3n
    sequential scan steps into (B, bw)-wide elementwise work."""
    idx = None if perm is None else jnp.asarray(np.asarray(perm))
    rows = jnp.arange(n)
    offs = jnp.arange(bw + 1)

    def spd(A, b):
        Ap = A if idx is None else A[idx][:, idx]
        bp = b if idx is None else b[idx]
        cols = rows[:, None] - bw + offs[None, :]
        Ab = jnp.where(
            cols >= 0, Ap[rows[:, None], jnp.clip(cols, 0, n - 1)], 0.0)
        x_p, fail = banded_spd_solve(Ab, bp)
        if idx is None:
            return x_p, fail
        x = jnp.zeros_like(x_p).at[idx].set(x_p)
        return x, fail

    return spd


def dense_to_band(A: jnp.ndarray, bw: int) -> jnp.ndarray:
    """Extract the lower band of a dense (n, n) matrix (test helper)."""
    n = A.shape[0]
    Ab = jnp.zeros((n, bw + 1), A.dtype)
    for d in range(bw + 1):
        col = jnp.arange(n) - bw + d
        vals = jnp.where(
            col >= 0, A[jnp.arange(n), jnp.clip(col, 0, n - 1)], 0.0
        )
        Ab = Ab.at[:, d].set(vals)
    return Ab
