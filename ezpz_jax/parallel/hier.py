"""Hierarchical sharded Schur solve: BASELINE-scale coupled systems.

``ShardedSchurSolver`` (``schur.py``) factors each device's interior DENSE
((n/D)^2 memory, (n/D)^3 flops) — fine to ~10k variables, hopeless at the
BASELINE 1M-var target. ``BlockSchurSolver`` (``block_schur.py``) factors
MANY SMALL interiors as one vmapped batch with a shared boundary — linear
memory — but lives on one chip.

This solver is their composition, the batched analog of a two-level
nested dissection (the role a multifrontal sparse LLT plays for the
reference's faer backend, ``ezpz/src/solver/newton.rs:87-102``):

    level 1   partition variables into P small parts (~tens of vars);
              batched Cholesky factors all interiors at once
    level 2   shard the part axis over a D-device mesh; the shared
              boundary B is replicated, and its (damped) Schur system
              solves by DISTRIBUTED conjugate gradients — each matvec is
              one (n_b,) psum; the (n_b, n_b) Schur matrix is never
              materialized anywhere

Per-device memory is O((P/D) * (m + k_b)^2) for the normal-equation blocks
plus O(n_vars) replicated state — linear in system size — so a million
variables fit one card's memory (and, padded down, a faked 8-device CPU
mesh).

CG on the Schur complement is Jacobi-preconditioned by default: diag(S)
assembles with one extra (n_b,) psum per LM step, and boundary chains
(whose Schur complement conditions like a 1-D Laplacian) converge orders
of magnitude faster — the difference between CG being a footnote and the
whole solve stalling at ``cg_max_iters`` matvecs per iteration.

Semantics mirror ``solve_lm``: damped accept/reject with the reference's
lambda schedule, residual/step convergence, degenerate flags, unweighted
1e-4 satisfaction. Residual rows always evaluate in the solve dtype (f64)
at the true point; ``precision="mixed"`` drops Jacobians, normal equations,
factorizations, and CG to f32 (inexact Newton, verified in f64).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P_

from ..config import LM_LAMBDA_DECR, LM_LAMBDA_INCR, Config
from ..constraints import Constraint
from ..models.compiled import EPSILON
from ..ops.kernels import KERNELS
from ..ops.linalg import (spd_solve, spd_solve_batched, spd_solve_multi,
                          spd_solve_multi_batched)
from .schur import partition_variables, resolve_boundary_solver

# f32 contractions on the mixed paths must not drop to TF32 or bf16
# multiplies, which would keep the f64-verified residual from 1e-8.
_HIGHEST = jax.lax.Precision.HIGHEST

from jax import shard_map as _shard_map


def _pcg(matvec, b, minv_diag, tol, max_iters):
    """Jacobi-preconditioned CG, jit-friendly; ``tol`` is absolute on the
    residual norm. ``minv_diag``: elementwise inverse preconditioner."""

    def cond(s):
        _x, r, _z, _p, rz, it = s
        return jnp.logical_and(jnp.vdot(r, r) > tol * tol, it < max_iters)

    def body(s):
        x, r, z, p, rz, it = s
        ap = matvec(p)
        alpha = rz / jnp.vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = minv_diag * r
        rz_new = jnp.vdot(r, z)
        p = z + (rz_new / rz) * p
        return (x, r, z, p, rz_new, it + 1)

    r0 = b
    z0 = minv_diag * r0
    state = (jnp.zeros_like(b), r0, z0, z0, jnp.vdot(r0, z0),
             jnp.asarray(0, jnp.int32))
    x, _r, _z, _p, _rz, _it = jax.lax.while_loop(cond, body, state)
    return x


class ShardedBlockSchurSolver:
    """Two-level partitioned-Schur LM solver over a device mesh.

    ``n_parts``/``part_of_var`` control the level-1 dissection exactly as
    in ``BlockSchurSolver`` (interiors near the unrolled-Cholesky tier are
    the sweet spot); parts are dealt to devices contiguously and padded to
    a uniform count. ``boundary_solver="cg"`` (default) never materializes
    the Schur matrix; ``"dense"`` replicates and Cholesky-factors it (only
    for small boundaries).

    >>> import numpy as np
    >>> from ezpz_jax import Constraint, DatumPoint
    >>> from ezpz_jax.parallel import ShardedBlockSchurSolver
    >>> p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    >>> r, s = DatumPoint(4, 5), DatumPoint(6, 7)
    >>> cs = [Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0),
    ...       Constraint.Distance(p, q, 2.0),
    ...       Constraint.Fixed(4, 1.0), Constraint.Fixed(5, 0.0),
    ...       Constraint.Distance(r, s, 2.0),
    ...       Constraint.ScalarEqual(3, 7)]
    >>> out = ShardedBlockSchurSolver(cs, 8, n_parts=2).solve(
    ...     np.array([0.0, 0.0, 1.4, 1.5, 1.0, 0.0, 2.4, 1.6]))
    >>> out["converged"] and out["n_boundary"] == 2
    True
    """

    def __init__(
        self,
        constraints: Sequence[Constraint],
        n_vars: int,
        n_parts: Optional[int] = None,
        part_of_var: Optional[np.ndarray] = None,
        mesh: Optional[Mesh] = None,
        weights: Optional[Sequence[float]] = None,
        config: Config = Config(),
        precision: str = "mixed",
        dtype=jnp.float64,
        boundary_solver: str = "cg",
        cg_tol: Optional[float] = None,
        cg_max_iters: int = 400,
    ):
        assert precision in ("f64", "mixed"), precision
        assert boundary_solver in ("dense", "cg", "banded", "auto"), \
            boundary_solver
        if mesh is None:
            mesh = Mesh(np.array(jax.devices()), ("d",))
        self.mesh = mesh
        D = int(mesh.devices.size)
        self.D = D
        if n_parts is None and part_of_var is None:
            n_parts = max(D, int(np.ceil(n_vars / 40)))
        if part_of_var is None:
            part_of_var = np.minimum(
                np.arange(n_vars) * n_parts // max(n_vars, 1), n_parts - 1
            )
        part_of_var = np.asarray(part_of_var)
        P = int(part_of_var.max()) + 1 if n_vars else 1
        self.config = config
        self.precision = precision
        self.dtype = dtype
        self.jac_dtype = jnp.float32 if precision == "mixed" else dtype
        if cg_tol is None:
            cg_tol = 1e-5 if precision == "mixed" else 1e-12
        self.cg_tol = float(cg_tol)
        self.cg_max_iters = int(cg_max_iters)
        self.boundary_solver = boundary_solver
        self.n_vars = n_vars
        self.n_constraints = len(constraints)
        if weights is None:
            weights = [1.0] * len(constraints)

        _pv, boundary = partition_variables(constraints, n_vars, P, part_of_var)
        bset = set(boundary)
        self.boundary = boundary
        self.n_b = n_b = len(boundary)
        b_slot = {g: j for j, g in enumerate(boundary)}
        # Interior membership without an O(n_vars * P) sweep.
        interior: List[List[int]] = [[] for _ in range(P)]
        for v in range(n_vars):
            if v not in bset:
                interior[int(part_of_var[v])].append(v)
        m = max((len(iv) for iv in interior), default=0)
        self.m = m

        # Constraint -> part (single-home local, couplers round-robin).
        per_part: List[List[int]] = [[] for _ in range(P)]
        rr = 0
        for cid, c in enumerate(constraints):
            ids = c.dependent_variable_ids()
            homes = {int(part_of_var[v]) for v in ids}
            if len(homes) == 1:
                per_part[homes.pop()].append(cid)
            else:
                per_part[rr % P].append(cid)
                rr += 1

        # Per-part LOCAL boundary (only touched boundary vars).
        local_b: List[List[int]] = []
        for p in range(P):
            touched = sorted({
                v for cid in per_part[p]
                for v in constraints[cid].dependent_variable_ids()
                if v in bset
            })
            local_b.append(touched)
        kb = max((len(t) for t in local_b), default=0)
        self.kb = kb
        n_loc = m + kb

        # Pad the part axis to D * Pl and shape everything (D, Pl, ...).
        Pl = (P + D - 1) // D
        self.P, self.Pl = P, Pl
        Ppad = D * Pl

        l2g = np.full((Ppad, n_loc), n_vars, dtype=np.int32)
        g2l = [dict() for _ in range(P)]
        bmap = np.full((Ppad, kb), n_b, dtype=np.int32)
        int_map = np.full((Ppad, m), n_vars, dtype=np.int32)
        imask = np.zeros((Ppad, m))
        for p in range(P):
            for i, g in enumerate(interior[p]):
                l2g[p, i] = g
                g2l[p][g] = i
                int_map[p, i] = g
            for j, g in enumerate(local_b[p]):
                l2g[p, m + j] = g
                g2l[p][g] = m + j
                bmap[p, j] = b_slot[g]
            imask[p, : len(interior[p])] = 1.0

        # Banded-boundary half-bandwidth: widest within-part boundary span
        # (chain couplings keep this at the interface width regardless of
        # P; see parallel/block_schur.py and ops/banded.py).
        spans = [
            int(r.max() - r.min())
            for p in range(Ppad)
            for r in (bmap[p][bmap[p] < n_b],)
            if r.size
        ]
        self.band_bw = max(spans, default=0)
        self.boundary_solver = resolve_boundary_solver(
            self.boundary_solver, n_b, self.band_bw
        )

        def dev_shape(a):
            return a.reshape((D, Pl) + a.shape[1:])

        self.l2g = dev_shape(l2g)
        self.bmap = dev_shape(bmap)
        self.int_map = dev_shape(int_map)
        self.imask = dev_shape(imask)

        # Stacked per-kind kernel blocks with local indices (both dtypes:
        # residuals in solve dtype, Jacobians in jac_dtype).
        per_part_kinds: List[dict] = []
        for p in range(P):
            slots: dict = {}
            for cid in per_part[p]:
                for inst in constraints[cid].lower():
                    ks = slots.setdefault(
                        inst.kernel, {"idx": [], "par": [], "w": [], "cid": []}
                    )
                    ks["idx"].append(tuple(g2l[p][v] for v in inst.var_ids))
                    ks["par"].append(inst.params)
                    ks["w"].append(weights[cid])
                    ks["cid"].append(cid)
            per_part_kinds.append(slots)
        all_kinds = sorted({k for s in per_part_kinds for k in s})
        self.jblocks = []
        for kind in all_kinds:
            spec = KERNELS[kind]
            n_max = max(
                len(per_part_kinds[p].get(kind, {"idx": []})["idx"])
                for p in range(P)
            )
            idx = np.zeros((Ppad, n_max, spec.nvars), dtype=np.int32)
            par = np.zeros((Ppad, n_max, spec.nparams), dtype=np.float64)
            wgt = np.zeros((Ppad, n_max), dtype=np.float64)
            cid = np.full((Ppad, n_max), self.n_constraints, dtype=np.int32)
            for p in range(P):
                ks = per_part_kinds[p].get(kind)
                if not ks or not ks["idx"]:
                    continue
                nn = len(ks["idx"])
                idx[p, :nn] = np.asarray(ks["idx"], np.int32)
                par[p, :nn] = np.asarray(ks["par"], np.float64).reshape(
                    nn, spec.nparams
                )
                wgt[p, :nn] = ks["w"]
                cid[p, :nn] = ks["cid"]
            self.jblocks.append((
                spec,
                dev_shape(idx),
                dev_shape(par.astype(np.dtype(dtype))),
                dev_shape(par.astype(np.dtype(self.jac_dtype))),
                dev_shape(wgt.astype(np.dtype(dtype))),
                dev_shape(wgt.astype(np.dtype(self.jac_dtype))),
                dev_shape(cid),
            ))

        self._sharded = None  # built lazily

    # -- the sharded LM loop ------------------------------------------------

    def _build(self):
        mesh = self.mesh
        m, kb, n_b = self.m, self.kb, self.n_b
        n_vars = self.n_vars
        dtype = self.dtype
        jt = self.jac_dtype
        cfg = self.config
        max_iterations = cfg.max_iterations
        n_cons = self.n_constraints

        jblock_arrays = tuple(
            (jnp.asarray(idx), jnp.asarray(par64), jnp.asarray(parj),
             jnp.asarray(w64), jnp.asarray(wj), jnp.asarray(cid))
            for (_spec, idx, par64, parj, w64, wj, cid) in self.jblocks
        )
        specs = [b[0] for b in self.jblocks]

        l2g_all = jnp.asarray(self.l2g)
        bmap_all = jnp.asarray(self.bmap)
        int_map_all = jnp.asarray(self.int_map)
        imask_all = jnp.asarray(self.imask)

        def device_fn(l2g, bmap, int_map, imask, jbs, x0, rtol, stol, lam0):
            # Per-device shapes: l2g (1, Pl, n_loc) etc.; x0 (n_vars,) repl.
            l2g = l2g[0]
            bmap = bmap[0]
            int_map = int_map[0]
            imask_d = imask[0].astype(jt)  # (Pl, m)
            jbs = tuple(tuple(a[0] for a in blk) for blk in jbs)

            def gather(xl, idx):
                # xl (Pl, n_loc), idx (Pl, nb, nv) -> (Pl, nb, nv)
                return jnp.take_along_axis(
                    xl[:, :, None], idx.transpose(0, 2, 1), axis=1
                ).transpose(0, 2, 1)

            # One packed psum per reduction instead of psum+pmax pairs:
            # max-reduced scalars ride in a one-hot device slot and take
            # jnp.max after the sum (every collective is a full-mesh
            # barrier; see parallel/schur.py for the same pattern).
            D_mesh = mesh.devices.size
            dev_onehot = jnp.arange(D_mesh) == jax.lax.axis_index("d")

            def residual_stats(x):
                """psum'd (r2, rinf, deg, worst) at replicated x (f64)."""
                x_ext = jnp.concatenate([x, jnp.zeros((1,), dtype)])
                x_loc = x_ext[l2g]  # (Pl, n_loc)
                r2 = jnp.zeros((), dtype)
                rinf = jnp.zeros((), dtype)
                deg = jnp.zeros((n_cons + 1,), jnp.bool_)
                worst = jnp.zeros((n_cons + 1,), dtype)
                for spec, (idx, par64, _pj, w64, _wj, cid) in zip(specs, jbs):
                    res, dg = jax.vmap(jax.vmap(spec.fn))(
                        gather(x_loc, idx), par64)
                    wres = res * w64[:, :, None]
                    r2 = r2 + jnp.sum(wres * wres)
                    rinf = jnp.maximum(rinf, jnp.max(jnp.abs(wres)))
                    live = w64 > 0
                    if spec.can_degenerate:
                        deg = deg.at[cid].max(dg & live)
                    worst = worst.at[cid].max(
                        jnp.max(jnp.abs(res), axis=2) * live)
                packed = jax.lax.psum(
                    jnp.concatenate(
                        [r2[None], jnp.where(dev_onehot, rinf, 0.0)]
                    ),
                    "d",
                )
                return packed[0], jnp.max(packed[1:]), deg, worst

            def normal_eq(x):
                """(jtj (Pl, n_loc, n_loc), jtr (Pl, n_loc), deg) in jt."""
                n_loc = m + kb
                x_ext = jnp.concatenate([x, jnp.zeros((1,), dtype)])
                x_loc = x_ext[l2g]
                x_loc_j = x_loc.astype(jt)
                Pl = x_loc.shape[0]
                jtj = jnp.zeros((Pl, n_loc, n_loc), jt)
                jtr = jnp.zeros((Pl, n_loc), jt)
                deg = jnp.zeros((n_cons + 1,), jnp.bool_)
                for spec, (idx, par64, parj, w64, wj, cid) in zip(specs, jbs):
                    fn = spec.fn

                    def jac_only(vv, pp, fn=fn):
                        return jax.jacfwd(lambda z: fn(z, pp)[0])(vv)

                    # Residual rows in f64 at the true point (mixed-path
                    # refinement structure); Jacobian in jt.
                    res64, dg = jax.vmap(jax.vmap(fn))(
                        gather(x_loc, idx), par64)
                    jac = jax.vmap(jax.vmap(jac_only))(
                        gather(x_loc_j, idx), parj)
                    wres = (res64 * w64[:, :, None]).astype(jt)
                    wjac = jac * wj[:, :, None, None]
                    contrib = jnp.einsum("pndk,pndl->pnkl", wjac, wjac,
                                         precision=_HIGHEST)
                    jtj = jtj.at[
                        jnp.arange(Pl)[:, None, None, None],
                        idx[:, :, :, None],
                        idx[:, :, None, :],
                    ].add(contrib)
                    jtr = jtr.at[jnp.arange(Pl)[:, None, None], idx].add(
                        jnp.einsum("pndk,pnd->pnk", wjac, wres, precision=_HIGHEST)
                    )
                    if spec.can_degenerate:
                        deg = deg.at[cid].max(dg & (wj > 0))
                return jtj, jtr, deg[:n_cons]

            def schur_step(x, lam):
                """Damped two-level Schur step at replicated x.
                Returns (d (n_vars,) f64 replicated, fail, deg_j)."""
                jtj, jtr, deg_j = normal_eq(x)
                # No f32 damping floor (see block_schur.py: softest modes
                # of big coupled systems sit near f32 round-off).
                lam_j = lam.astype(jt)
                eye_m = jnp.eye(m, dtype=jt)
                a_ii = (
                    jtj[:, :m, :m]
                    + lam_j * eye_m * imask_d[:, None, :]
                    + (1.0 - imask_d)[:, :, None] * eye_m
                )
                a_ib = jtj[:, :m, m:]  # (Pl, m, kb)
                a_bb = jtj[:, m:, m:]  # (Pl, kb, kb)
                b_i = -jtr[:, :m]
                b_b = -jtr[:, m:]

                # Interiors are a HEAVILY-BATCHED small-matrix regime: the
                # *_batched tiers route 24 < n_loc <= 64 to the matmul-free
                # column-sweep solve (ops/linalg._midsize_spd_solve) instead
                # of XLA's serialized small cholesky; <= 24 is unchanged.
                if n_b:
                    # ONE interior factorization: pack b_i next to A_ib so
                    # u and W share the factorization + substitution sweep,
                    # and reuse W for the interior back-substitution
                    # (d_i = u - W d_b) instead of a third solve.
                    packed = jnp.concatenate([b_i[:, :, None], a_ib], 2)
                    sol, fail_i = jax.vmap(spd_solve_multi_batched)(
                        a_ii, packed)
                    fail_i = jnp.any(fail_i)
                    u = sol[:, :, 0]
                    w_mat = sol[:, :, 1:]

                    def scatter_b(contrib):
                        # (Pl, kb) -> (n_b,) local sum (dummy row dropped)
                        buf = jnp.zeros((n_b + 1,), jt).at[bmap].add(contrib)
                        return buf[:n_b]

                    rhs_contrib = scatter_b(
                        b_b - jnp.einsum("pmk,pm->pk", a_ib, u))

                    def s_matvec(v):
                        v_ext = jnp.concatenate([v, jnp.zeros((1,), jt)])
                        v_loc = v_ext[bmap]  # (Pl, kb)
                        t = jnp.einsum("pkj,pj->pk", a_bb, v_loc)
                        t = t - jnp.einsum(
                            "pmk,pm->pk", a_ib,
                            jnp.einsum("pmk,pk->pm", w_mat, v_loc))
                        return jax.lax.psum(scatter_b(t), "d") + lam_j * v

                    if self.boundary_solver == "cg":
                        # Jacobi preconditioner diag(S) rides in the SAME
                        # psum as the boundary rhs.
                        diag_local = jnp.einsum("pkk->pk", a_bb) - jnp.einsum(
                            "pmk,pmk->pk", a_ib, w_mat)
                        packed_b = jax.lax.psum(
                            jnp.concatenate(
                                [rhs_contrib, scatter_b(diag_local)]),
                            "d")
                        rhs = packed_b[:n_b]
                        diag_s = packed_b[n_b:] + lam_j
                        minv = jnp.where(diag_s > 0, 1.0 / diag_s,
                                         jnp.ones_like(diag_s))
                        tol = self.cg_tol * jnp.sqrt(jnp.vdot(rhs, rhs))
                        d_b = _pcg(s_matvec, rhs, minv, tol,
                                   self.cg_max_iters)
                        fail_b = jnp.asarray(False)
                    elif self.boundary_solver == "banded":
                        # Exact banded direct solve for chain-like
                        # couplings: assemble only the lower band locally,
                        # psum it (rhs rides as an extra column — ONE
                        # collective for the whole boundary system), then
                        # every device runs the same O(n_b * bw^2)
                        # replicated scan factorization. Replaces the CG
                        # matvec loop (one psum PER matvec) entirely.
                        from ..ops.banded import banded_spd_solve

                        bw = self.band_bw
                        s_contrib = a_bb - jnp.einsum(
                            "pmk,pmj->pkj", a_ib, w_mat)
                        shape3 = s_contrib.shape
                        rows = jnp.broadcast_to(bmap[:, :, None], shape3)
                        cols = jnp.broadcast_to(bmap[:, None, :], shape3)
                        off = cols - rows + bw
                        bad = ((rows >= n_b) | (cols >= n_b)
                               | (off < 0) | (off > bw))
                        rows_s = jnp.where(bad, n_b, rows)
                        off_s = jnp.where(bad, bw + 1, off)
                        band_buf = jnp.zeros((n_b + 1, bw + 2), jt)
                        band_buf = band_buf.at[rows_s, off_s].add(s_contrib)
                        packed_band = jax.lax.psum(
                            jnp.concatenate(
                                [band_buf[:n_b, :bw + 1],
                                 rhs_contrib[:, None]], 1), "d")
                        band = packed_band[:, :bw + 1].at[:, bw].add(lam_j)
                        rhs = packed_band[:, bw + 1]
                        d_b, fail_b = banded_spd_solve(band, rhs)
                    else:
                        # The boundary rhs rides as an extra row of the
                        # Schur-matrix psum (one collective, as in
                        # parallel/schur.py's dense path).
                        s_contrib = a_bb - jnp.einsum(
                            "pmk,pmj->pkj", a_ib, w_mat)
                        s_buf = jnp.zeros((n_b + 1, n_b + 1), jt)
                        s_buf = s_buf.at[
                            bmap[:, :, None], bmap[:, None, :]
                        ].add(s_contrib)
                        packed_s = jax.lax.psum(
                            jnp.concatenate(
                                [s_buf[:n_b, :n_b], rhs_contrib[None, :]],
                                0),
                            "d")
                        s_mat = packed_s[:n_b] \
                            + lam_j * jnp.eye(n_b, dtype=jt)
                        rhs = packed_s[n_b]
                        d_b, fail_b = spd_solve(s_mat, rhs)
                    d_b_ext = jnp.concatenate([d_b, jnp.zeros((1,), jt)])
                    d_b_loc = d_b_ext[bmap]
                    d_i = u - jnp.einsum("pmk,pk->pm", w_mat, d_b_loc)
                else:
                    u, fail_i = jax.vmap(spd_solve_batched)(a_ii, b_i)
                    fail_i = jnp.any(fail_i)
                    fail_b = jnp.asarray(False)
                    d_b = jnp.zeros((0,), jt)
                    d_i = u
                d_i = d_i * imask_d
                # Interior scatter is per-device partial; psum unions the
                # disjoint contributions into the replicated step. The
                # fail flag rides in an extra slot of the same psum
                # (slot n_vars is the padded-lane dummy, slot n_vars+1 the
                # flag) instead of its own pmax barrier.
                d = jnp.zeros((n_vars + 2,), dtype)
                d = d.at[int_map].add(d_i.astype(dtype))
                d = d.at[n_vars + 1].set(
                    jnp.maximum(fail_i.astype(dtype), fail_b.astype(dtype)))
                dsum = jax.lax.psum(d, "d")
                fail = dsum[n_vars + 1] > 0
                d = dsum[:n_vars]
                if n_b:
                    d = d.at[jnp.asarray(self.boundary, jnp.int32)].add(
                        d_b.astype(dtype))
                d = jnp.where(fail, jnp.zeros_like(d), d)
                return d, fail, deg_j

            r2_0, rinf_0, deg0, _w0 = residual_stats(x0)
            state = dict(
                x=x0,
                r2=r2_0,
                rinf=rinf_0,
                lam=jnp.asarray(lam0, dtype),
                it=jnp.asarray(0, jnp.int32),
                done=jnp.asarray(False),
                converged=jnp.asarray(False),
                iterations=jnp.asarray(0, jnp.int32),
                deg=deg0,
            )

            def cond(s):
                return (~s["done"]) & (s["it"] < max_iterations) & \
                    (s["rinf"] > rtol)

            def body(s):
                d, fail, deg_j = schur_step(s["x"], s["lam"])
                step_inf = jnp.max(jnp.abs(d))
                x_new = s["x"] + d
                r2_new, rinf_new, deg_r, _wn = residual_stats(x_new)
                accept = jnp.logical_and(~fail, r2_new < s["r2"])
                out = dict(s)
                out["x"] = jnp.where(accept, x_new, s["x"])
                out["r2"] = jnp.where(accept, r2_new, s["r2"])
                out["rinf"] = jnp.where(accept, rinf_new, s["rinf"])
                out["lam"] = jnp.where(
                    accept, s["lam"] * LM_LAMBDA_DECR,
                    s["lam"] * LM_LAMBDA_INCR)
                out["deg"] = (s["deg"] | deg_r).at[:n_cons].max(deg_j)
                step_conv = (~fail) & (step_inf <= stol)
                out["done"] = step_conv
                out["converged"] = s["converged"] | step_conv
                out["iterations"] = jnp.where(
                    step_conv, s["it"], s["iterations"])
                out["it"] = s["it"] + 1
                return out

            final = jax.lax.while_loop(cond, body, state)
            res_conv = final["rinf"] <= rtol
            converged = final["converged"] | res_conv
            iterations = jnp.where(
                final["done"],
                final["iterations"],
                jnp.where(res_conv, final["it"],
                          jnp.asarray(max_iterations, jnp.int32)),
            )
            _r2f, _rf, _degf, worst_f = residual_stats(final["x"])
            # worst/deg are per-device partial (each constraint is homed on
            # exactly one part): combine with ONE fused max across the mesh.
            wd = jax.lax.pmax(
                jnp.concatenate([worst_f, final["deg"].astype(dtype)]), "d")
            worst_all = wd[: n_cons + 1]
            deg_all = wd[n_cons + 1:] > 0
            sat = worst_all[:n_cons] < EPSILON
            return (
                final["x"],
                iterations,
                converged,
                deg_all[None, :n_cons],
                sat[None, :],
                final["rinf"],
            )

        n_blk = len(self.jblocks)
        blk_specs = tuple(
            (P_("d"),) * 6 for _ in range(n_blk)
        )
        sharded = _shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(P_("d"), P_("d"), P_("d"), P_("d"), blk_specs,
                      P_(), P_(), P_(), P_()),
            out_specs=(P_(), P_(), P_(), P_("d"), P_("d"), P_()),
            check_vma=False,
        )

        def run(x0, rtol, stol, lam0):
            with jax.default_matmul_precision("highest"):
                return sharded(
                    l2g_all, bmap_all, int_map_all, imask_all,
                    jblock_arrays, x0, rtol, stol, lam0)

        self._sharded = jax.jit(run)

    def solve(self, x0) -> dict:
        if self._sharded is None:
            self._build()
        c = self.config
        x, iterations, converged, deg, sat, rinf = self._sharded(
            jnp.asarray(x0, self.dtype),
            jnp.asarray(c.residual_tolerance, self.dtype),
            jnp.asarray(c.step_tolerance, self.dtype),
            jnp.asarray(c.initial_lambda, self.dtype),
        )
        deg = np.asarray(deg)
        sat = np.asarray(sat)
        return dict(
            x=np.asarray(x),
            iterations=int(iterations),
            converged=bool(converged),
            satisfied=sat.reshape(-1, sat.shape[-1])[0],
            degenerate=deg.reshape(-1, deg.shape[-1])[0],
            residual_inf=float(rinf),
            n_boundary=self.n_b,
            n_interior=self.m,
            n_parts=self.P,
            n_devices=self.D,
        )
