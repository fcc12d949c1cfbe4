"""SPD solves for the LM normal equations.

Two tiers by system size:

* n <= 24 — fully unrolled Cholesky-Crout: pure elementwise ops that
  fuse into the surrounding LM loop, where a library batched
  factorization of many tiny matrices pays per-matrix overhead.
* 24 < n — XLA's ``cholesky`` + triangular solves, wrapped with the
  NaN-as-failure semantics the LM loop needs. This is the tier the
  reference serves with faer's sparse LLT (``newton.rs:87-102``,
  ``solver.rs:270-300``).

A hand-blocked right-looking alternative (``_blocked_spd_solve``: unrolled
diagonal-block Crout + triangular inverse, panel/trailing matmuls over
32-wide panels) is kept parity-tested but is not the default (opt-in via
``_blocked_spd_solve`` only). Which tier wins per n on the GPU is not yet
measured (ROADMAP Design D4).

Failure semantics everywhere: a non-SPD matrix yields NaN (sqrt of a
negative), which is detected and reported as ``fail`` with a zero-filled,
finite ``x`` — the LM loop treats it as a rejected step (mirroring faer's
LltError::Numeric, ``newton.rs:96-99``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Above this size the unrolled program gets big; switch to the blocked tier.
UNROLL_MAX_N = 24
# Panel width of the blocked tier. 32 keeps the unrolled diagonal factor
# (nb^3/6 scalar ops) and triangular inverse tractable for the tracer while
# giving the matmuls a deep enough contraction; the trailing update dominates
# FLOPs and runs at full width regardless.
BLOCK_NB = 32


def _chol_unrolled(A):
    """Lower Cholesky factor as an n x n list of scalars (leading batch dims
    broadcast through). Unrolled Cholesky-Crout."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    return L


def _solve_unrolled(L, b):
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def _chol_small(D: jnp.ndarray) -> jnp.ndarray:
    """Left-looking Cholesky of one (nb, nb) SPD block: a PYTHON loop over
    columns (unrolled at trace time — nb vector ops, not nb^3 scalars), each
    column a masked full-width vector update. Unrolling matters: as a
    ``fori_loop`` these 2*nb tiny sequential vector ops per panel dominated the
    whole blocked factorization (~4k micro-dispatches for n=2048); unrolled,
    XLA fuses them into a handful of kernels. Column list -> one stack at
    the end (no per-column full-matrix updates)."""
    nb = D.shape[-1]
    idx = jnp.arange(nb)
    cols = []
    for j in range(nb):
        s = D[:, j]
        for k in range(0, j):
            s = s - cols[k] * cols[k][j]
        d = jnp.sqrt(s[j])
        cols.append(jnp.where(idx == j, d, jnp.where(idx > j, s / d, 0.0)))
    return jnp.stack(cols, axis=1)


def _tri_inv_small(L: jnp.ndarray) -> jnp.ndarray:
    """Inverse of a lower-triangular (nb, nb) block: forward substitution on
    all identity columns simultaneously, one (unrolled) row at a time."""
    nb = L.shape[-1]
    eye = jnp.eye(nb, dtype=L.dtype)
    rows = []
    for i in range(nb):
        s = eye[i]
        for k in range(0, i):
            s = s - L[i, k] * rows[k]
        rows.append(s / L[i, i])
    return jnp.stack(rows, axis=0)


def _chol_blocked(A: jnp.ndarray, nb: int):
    """Blocked right-looking Cholesky of SPD ``A`` (n, n) with n a multiple
    of ``nb``. Returns ``(L, inv_diag)`` where ``L`` is lower triangular and
    ``inv_diag`` (K, nb, nb) holds the inverses of the diagonal blocks (a
    factorization byproduct that makes the triangular solves matmul-only).

    Static shapes throughout: each step slices the full-height panel,
    factors the diagonal block with the unrolled Crout, forms the panel via
    one (n, nb) x (nb, nb) matmul against the unrolled triangular inverse,
    and applies the trailing update as a masked full-width Z Z^T — rows
    already factored are zeroed, so the subtraction only touches the
    trailing submatrix. The masked update does ~6x the minimal FLOPs but
    keeps every matmul static-shaped.
    """
    n = A.shape[-1]
    K = n // nb
    rows = jnp.arange(n)[:, None]

    def step(k, carry):
        M, inv_diag = carry
        col = jax.lax.dynamic_slice(M, (0, k * nb), (n, nb))
        diag = jax.lax.dynamic_slice(M, (k * nb, k * nb), (nb, nb))
        inv_mat = _tri_inv_small(_chol_small(diag))
        # Panel: Y = col @ inv(L_kk)^T; the diag-block rows of Y come out as
        # L_kk itself. Rows above the panel hold upper-triangle junk of the
        # symmetric input — zero them so the stored factor is clean.
        Y = jnp.where(rows >= k * nb, col @ inv_mat.T, 0)
        M = jax.lax.dynamic_update_slice(M, Y, (0, k * nb))
        inv_diag = jax.lax.dynamic_update_slice(
            inv_diag, inv_mat[None], (k, 0, 0)
        )
        # Trailing update: Z zeroes the diag block too, so Z Z^T is nonzero
        # only where BOTH row and column are >= (k+1)*nb.
        Z = jnp.where(rows >= (k + 1) * nb, Y, 0)
        M = M - Z @ Z.T
        return M, inv_diag

    M, inv_diag = jax.lax.fori_loop(
        0, K, step, (A, jnp.zeros((K, nb, nb), A.dtype))
    )
    return jnp.tril(M), inv_diag


def _blocked_tri_solves(L, inv_diag, b, nb: int):
    """x = L^-T L^-1 b using the blocked factor. ``b`` is (n,) or (n, m)."""
    n = L.shape[-1]
    K = n // nb
    vec = b.ndim == 1
    y0 = (b[:, None] if vec else b) * 0.0
    bm = b[:, None] if vec else b
    m = bm.shape[1]

    def fwd(k, y):
        # y_k = inv(L_kk) (b_k - L[k-rows, :] y); unsolved slots of y are
        # zero and the diag-block columns multiply those zeros, so the full
        # static-width row-block matvec sums exactly the solved prefix.
        row = jax.lax.dynamic_slice(L, (k * nb, 0), (nb, n))
        bk = jax.lax.dynamic_slice(bm, (k * nb, 0), (nb, m))
        inv_k = jax.lax.dynamic_slice(inv_diag, (k, 0, 0), (1, nb, nb))[0]
        yk = inv_k @ (bk - row @ y)
        return jax.lax.dynamic_update_slice(y, yk, (k * nb, 0))

    y = jax.lax.fori_loop(0, K, fwd, y0)

    def bwd(i, x):
        # x_k = inv(L_kk)^T (y_k - (column block k)^T x): only rows below
        # the panel carry solved x entries, the rest multiply zeros.
        k = K - 1 - i
        colb = jax.lax.dynamic_slice(L, (0, k * nb), (n, nb))
        yk = jax.lax.dynamic_slice(y, (k * nb, 0), (nb, m))
        inv_k = jax.lax.dynamic_slice(inv_diag, (k, 0, 0), (1, nb, nb))[0]
        xk = inv_k.T @ (yk - colb.T @ x)
        return jax.lax.dynamic_update_slice(x, xk, (k * nb, 0))

    x = jax.lax.fori_loop(0, K, bwd, y0)
    return x[:, 0] if vec else x


def _blocked_spd_solve(A: jnp.ndarray, B: jnp.ndarray, nb: int = BLOCK_NB):
    """Blocked-tier solve for one or many RHS. Pads n up to a multiple of
    ``nb`` with an identity tail (factors cleanly, contributes nothing)."""
    n = A.shape[-1]
    pad = (-n) % nb
    if pad:
        n_p = n + pad
        A_p = jnp.zeros((n_p, n_p), A.dtype)
        A_p = A_p.at[:n, :n].set(A)
        A_p = A_p.at[jnp.arange(n, n_p), jnp.arange(n, n_p)].set(1.0)
        B_p = jnp.zeros((n_p,) + B.shape[1:], B.dtype).at[:n].set(B)
    else:
        A_p, B_p = A, B
    L, inv_diag = _chol_blocked(A_p, nb)
    diag = jnp.diagonal(L)
    fail = ~jnp.all(jnp.isfinite(diag))
    # Sanitize so the substitution never propagates NaN/Inf into a result
    # that is discarded anyway (the caller zero-fills on failure).
    L = jnp.where(jnp.isfinite(L), L, 0.0)
    inv_diag = jnp.where(jnp.isfinite(inv_diag), inv_diag, 0.0)
    x = _blocked_tri_solves(L, inv_diag, B_p, nb)
    x = jnp.where(fail, jnp.zeros_like(x), x)[:n]
    return x, fail


def _xla_spd_solve(A: jnp.ndarray, B: jnp.ndarray):
    """Medium/large tier: XLA cholesky + triangular solves with the
    NaN-as-failure contract (one or many RHS)."""
    L = jnp.linalg.cholesky(A)
    diag = jnp.diagonal(L)
    fail = ~jnp.all(jnp.isfinite(diag))
    # Sanitize so the triangular solves never divide by NaN/0 when the
    # result is discarded anyway (the caller zero-fills on failure).
    L = jnp.where(jnp.isfinite(L), L, 0.0)
    safe = jnp.where(jnp.abs(jnp.diagonal(L)) > 0.0, jnp.diagonal(L), 1.0)
    L = L.at[jnp.arange(L.shape[-1]), jnp.arange(L.shape[-1])].set(safe)
    y = jax.scipy.linalg.solve_triangular(L, B, lower=True)
    x = jax.scipy.linalg.solve_triangular(L.T, y, lower=False)
    x = jnp.where(fail, jnp.zeros_like(x), x)
    return x, fail


def spd_solve(A: jnp.ndarray, b: jnp.ndarray):
    """Solve A x = b for SPD A.

    Returns ``(x, fail)`` where ``fail`` is a scalar bool (NaN encountered =>
    numerically non-SPD). ``x`` is zero-filled when failed. Shapes: A (n, n),
    b (n,) — batch via vmap (everything here is elementwise, so vmap is free).
    """
    n = A.shape[-1]
    if n == 0:
        return jnp.zeros_like(b), jnp.asarray(False)
    if n <= UNROLL_MAX_N:
        L = _chol_unrolled(A)
        diag = jnp.stack([L[i][i] for i in range(n)], axis=-1)
        fail = jnp.any(jnp.isnan(diag))
        # Sanitize the diagonal so the solve never divides by NaN/0 when the
        # result is discarded anyway.
        Lsafe = [row[:] for row in L]
        for i in range(n):
            Lsafe[i][i] = jnp.where(jnp.isnan(L[i][i]) | (L[i][i] == 0.0), 1.0, L[i][i])
            for k in range(i):
                Lsafe[i][k] = jnp.where(jnp.isnan(L[i][k]), 0.0, L[i][k])
        x = _solve_unrolled(Lsafe, b)
        x = jnp.where(fail, jnp.zeros_like(x), x)
        return x, fail
    return _xla_spd_solve(A, b)


# Column-unrolled tier cutoff for HEAVILY-BATCHED mid-size solves (see
# spd_solve_batched): 48 fits the partitioned-Schur interiors; above ~64
# the trace blows up and XLA's blocked algorithm wins anyway.
UNROLL_COL_MAX_N = 64


def _colunroll_spd_solve(A: jnp.ndarray, B: jnp.ndarray):
    """Mid-size tier for batched contexts: trace-time column-unrolled
    Cholesky + triangular inverse (pure vector ops that vectorize over a
    vmapped batch), solves as two matmuls.

    Its explicit-inverse matmuls need full f32 precision on the
    correctness-critical solver paths, so no production path routes here
    by default; it remains available for batched workloads."""
    L = _chol_small(A)
    diag = jnp.diagonal(L, axis1=-2, axis2=-1)
    fail = ~jnp.all(jnp.isfinite(diag))
    L = jnp.where(jnp.isfinite(L), L, 0.0)
    n = L.shape[-1]
    idx = jnp.arange(n)
    d = jnp.diagonal(L, axis1=-2, axis2=-1)
    safe = jnp.where(jnp.abs(d) > 0.0, d, 1.0)
    L = L.at[..., idx, idx].set(safe)
    Li = _tri_inv_small(L)
    x = Li.T @ (Li @ B)
    x = jnp.where(fail, jnp.zeros_like(x), x)
    return x, fail


def _midsize_spd_solve(A: jnp.ndarray, B: jnp.ndarray):
    """Matmul-FREE mid-size tier for batched contexts (24 < n <= 64).

    ``_colunroll_spd_solve`` pairs the column-unrolled factorization with
    explicit-inverse MATMULS, which must run at
    ``jax.default_matmul_precision("highest")`` (the setting every
    correctness-critical solver path bakes in). This tier keeps the
    vector-op factorization (``_chol_small``: one (n,)-vector update per
    (j, k) column pair, ~n^2/2 vector ops that broadcast over a vmapped
    batch) and replaces the solves with column-sweep substitutions — one
    (n,)-vector update per column, 2n ops per RHS — so NO matmul appears
    anywhere and matmul-precision context is irrelevant. Works for one
    RHS ``(n,)`` or many ``(n, m)``; batch via vmap.
    """
    n = A.shape[-1]
    L = _chol_small(A)
    diag = jnp.diagonal(L)
    fail = ~jnp.all(jnp.isfinite(diag))
    L = jnp.where(jnp.isfinite(L), L, 0.0)
    idx = jnp.arange(n)
    d = jnp.diagonal(L)
    safe = jnp.where(jnp.abs(d) > 0.0, d, 1.0)
    L = L.at[idx, idx].set(safe)

    vec = B.ndim == 1
    r = B[:, None] if vec else B  # (n, m)
    # Forward: y_j = r_j / L_jj, then eliminate column j from the
    # remainder. Rows <= j pick up junk from the full-column update, but
    # each y_j is read BEFORE its row is touched and rows < j are never
    # read again, so only the (correct) trailing rows matter.
    ys = []
    for j in range(n):
        yj = r[j] / L[j, j]
        ys.append(yj)
        r = r - L[:, j][:, None] * yj[None, :]
    y = jnp.stack(ys, axis=0)  # (n, m)
    # Backward with L^T: column sweep in reverse using ROWS of L.
    xs = [None] * n
    q = y
    for j in reversed(range(n)):
        xj = q[j] / L[j, j]
        xs[j] = xj
        q = q - L[j, :][:, None] * xj[None, :]
    x = jnp.stack(xs, axis=0)
    x = jnp.where(fail, jnp.zeros_like(x), x)
    return (x[:, 0] if vec else x), fail


def spd_solve_batched(A: jnp.ndarray, b: jnp.ndarray):
    """``spd_solve`` for callers that vmap MANY solves of this shape in
    one program: the 24 < n <= 64 tier uses the matmul-free column-sweep
    path (``_midsize_spd_solve``), which beats XLA's serialized
    small-matrix cholesky in heavily-batched regimes at ANY matmul
    precision. For a SINGLE matrix the serialized column chain is slower
    than XLA — use plain ``spd_solve`` there."""
    n = A.shape[-1]
    if UNROLL_MAX_N < n <= UNROLL_COL_MAX_N:
        return _midsize_spd_solve(A, b)
    return spd_solve(A, b)


def spd_solve_multi_batched(A: jnp.ndarray, B: jnp.ndarray):
    """``spd_solve_multi`` with the batched-context mid-size tier."""
    n = A.shape[-1]
    if UNROLL_MAX_N < n <= UNROLL_COL_MAX_N:
        return _midsize_spd_solve(A, B)
    return spd_solve_multi(A, B)


def spd_solve_multi(A: jnp.ndarray, B: jnp.ndarray):
    """Solve A X = B for SPD A with multiple right-hand sides B (n, m).
    Returns (X, fail)."""
    n = A.shape[-1]
    if n == 0:
        return jnp.zeros_like(B), jnp.asarray(False)
    if n <= UNROLL_MAX_N:
        L = _chol_unrolled(A)
        diag = jnp.stack([L[i][i] for i in range(n)], axis=-1)
        fail = jnp.any(jnp.isnan(diag))
        Lsafe = [row[:] for row in L]
        for i in range(n):
            Lsafe[i][i] = jnp.where(jnp.isnan(L[i][i]) | (L[i][i] == 0.0), 1.0, L[i][i])
            for k in range(i):
                Lsafe[i][k] = jnp.where(jnp.isnan(L[i][k]), 0.0, L[i][k])
        x = jax.vmap(lambda bb: _solve_unrolled(Lsafe, bb), in_axes=1, out_axes=1)(B)
        x = jnp.where(fail, jnp.zeros_like(x), x)
        return x, fail
    return _xla_spd_solve(A, B)
