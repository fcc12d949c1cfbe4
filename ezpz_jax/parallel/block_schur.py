"""Single-device partitioned Schur solve: nested dissection by batching.

The reference solves one big *coupled* sparse system with a serialized
sparse LLT on one core (``ezpz/src/solver/newton.rs:87-102``,
``solver.rs:270-300``). The batched equivalent of that sparsity
exploitation is NOT a sparse factorization — it is a partition: split the
variable vector into P contiguous interior blocks plus a shared boundary
(every variable touched by a cross-partition constraint), then each LM step
solves

    A = [[A_II, A_IB],    A_II block-diagonal over partitions,
         [A_BI, A_BB]]    boundary B shared

with a Schur complement:

    per partition p:  W_p = A_pp^-1 A_pB,   u_p = A_pp^-1 b_p
    S   = A_BB + lambda I - sum_p A_pB^T W_p     (segment-sum, no psum)
    x_B = S^-1 rhs                                (one small dense solve)
    x_p = A_pp^-1 (b_p - A_pB x_B)                (batched back-subst)

All P interior factorizations run as ONE vmapped batch through the
unrolled/blocked Cholesky tiers (``ops/linalg.py``) — the same trick that
makes the block-diagonal fleet path fast, now applied to systems that are
NOT block-diagonal. This is ``ShardedSchurSolver``'s math
(``parallel/schur.py``) with the device axis replaced by a batch axis: no
collectives, one chip, and it vmaps over fleets of same-topology systems.

Unlike the sharded solver, each partition only carries its LOCAL boundary
variables (the few its constraints actually touch), so memory stays
O(P * (m + k_b)^2) instead of O(P * (m + n_b)^2), and the boundary system
assembles by scatter-add instead of replication.

Residuals, accept/reject, and convergence run through the SAME shared LM
loop as every other path (``solver._lm_while_loop``) on the f64 compiled
system, so semantics match ``solve_lm`` exactly; with ``precision="mixed"``
only the Jacobian/normal-equation/factorization side drops to f32 (inexact
Newton; the 1e-8 verification stays f64).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..constraints import Constraint
from ..models.compiled import EPSILON, compile_system
from ..ops.kernels import KERNELS
from ..ops.linalg import (spd_solve, spd_solve_batched, spd_solve_multi,
                          spd_solve_multi_batched)
from ..solver import LMResult, _init_state, _lm_while_loop, _reference_result
from .schur import partition_variables, resolve_boundary_solver

# f32 contractions on the mixed paths must not drop to TF32 or bf16
# multiplies, which would keep the f64-verified residual from 1e-8.
_HIGHEST = jax.lax.Precision.HIGHEST


class BlockSchurSolver:
    """Partitioned-Schur LM solver for one coupled topology on one chip.

    ``n_parts`` controls the dissection: interiors of ~``n_vars/n_parts``
    variables factor as a single vmapped batch (sweet spot: interiors at or
    below the unrolled-Cholesky tier, ~24 vars). ``part_of_var`` overrides
    the default contiguous partition with an explicit var -> partition map.

    Two distance sketches coupled by a ``ScalarEqual`` across the cut —
    NOT block-diagonal, solved by partitioned Schur on one chip:

    >>> import numpy as np
    >>> from ezpz_jax import Constraint, DatumPoint
    >>> from ezpz_jax.parallel import BlockSchurSolver
    >>> p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    >>> r, s = DatumPoint(4, 5), DatumPoint(6, 7)
    >>> cs = [Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0),
    ...       Constraint.Distance(p, q, 2.0),
    ...       Constraint.Fixed(4, 1.0), Constraint.Fixed(5, 0.0),
    ...       Constraint.Distance(r, s, 2.0),
    ...       Constraint.ScalarEqual(3, 7)]
    >>> out = BlockSchurSolver(cs, 8, n_parts=2, precision="f64").solve(
    ...     np.array([0.0, 0.0, 1.4, 1.5, 1.0, 0.0, 2.4, 1.6]))
    >>> out["converged"] and out["n_parts"] == 2 and out["n_boundary"] == 2
    True
    """

    def __init__(
        self,
        constraints: Sequence[Constraint],
        n_vars: int,
        n_parts: Optional[int] = None,
        part_of_var: Optional[np.ndarray] = None,
        weights: Optional[Sequence[float]] = None,
        config: Config = Config(),
        precision: str = "mixed",
        dtype=jnp.float64,
        boundary_solver: str = "dense",
        cg_tol: Optional[float] = None,
        cg_max_iters: int = 400,
    ):
        """``boundary_solver="cg"``: solve the (n_b, n_b) Schur system by
        Jacobi-preconditioned CG using only the per-part factors — the
        Schur matrix is never materialized and its O(n_b^3) Cholesky
        (the critical path once the boundary grows past a few hundred
        variables) disappears. ``cg_tol`` is relative to |rhs|; default
        picks 1e-5 for f32 linear algebra (mixed) / 1e-12 for f64 — the
        LM accept/reject loop absorbs the inexactness (inexact Newton).

        ``boundary_solver="banded"``: EXACT direct solve for chain-like
        couplings. Under the natural boundary ordering a 1-D chain of
        parts yields a (block-)tridiagonal Schur complement; this path
        assembles only its lower band (half-bandwidth = the widest
        within-part boundary span, computed at build time) and factors it
        in O(n_b * bw^2) with ``ops.banded`` — no O(n_b^3) Cholesky, no
        CG matvec loop, and unlike CG the step is exact, so LM iteration
        counts match the dense path. The band captures S exactly
        (per-part blocks only touch that part's own boundary slots); a
        hub-like topology whose parts all touch one shared variable makes
        bw ~ n_b and the path degenerates to dense cost — check
        ``self.band_bw`` before choosing it.

        ``boundary_solver="auto"``: pick one of the three structurally at
        build time (``schur.resolve_boundary_solver``: banded for thin
        bands, dense for small boundaries, CG for the rest); the resolved
        choice is readable back from ``self.boundary_solver``."""
        assert precision in ("f64", "mixed"), precision
        assert boundary_solver in ("dense", "cg", "banded", "auto"), \
            boundary_solver
        # "auto" resolves structurally once n_b and band_bw are known
        # (end of __init__); see schur.resolve_boundary_solver.
        self.boundary_solver = boundary_solver
        if cg_tol is None:
            cg_tol = 1e-5 if precision == "mixed" else 1e-12
        self.cg_tol = float(cg_tol)
        self.cg_max_iters = int(cg_max_iters)
        if n_parts is None and part_of_var is None:
            # Target interiors near the unrolled-Cholesky tier.
            n_parts = max(1, int(np.ceil(n_vars / 40)))
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
        self.n_vars = n_vars
        self.n_constraints = len(constraints)
        if weights is None:
            weights = [1.0] * len(constraints)

        # The f64 system drives residuals, satisfaction, and degeneracy
        # through the exact same code path as solve_lm.
        self.system = compile_system(constraints, n_vars, weights, dtype)
        self.system_j = (
            self.system.astype(self.jac_dtype)
            if self.jac_dtype != dtype else self.system
        )

        _pv, boundary = partition_variables(
            constraints, n_vars, P, part_of_var
        )
        bset = set(boundary)
        self.boundary = boundary
        self.n_b = n_b = len(boundary)
        b_slot = {g: j for j, g in enumerate(boundary)}
        interior: List[List[int]] = [
            [v for v in range(n_vars) if part_of_var[v] == p and v not in bset]
            for p in range(P)
        ]
        self.P = P
        m = max((len(iv) for iv in interior), default=0)
        self.m = m

        # Constraint -> partition (same rule as schur.py: single-home
        # constraints to their partition, all-boundary couplers round-robin).
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

        # Per-partition LOCAL boundary: only the boundary vars its assigned
        # constraints touch.
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

        # Local index maps. l2g gathers x slices per partition (dummy slot
        # n_vars reads the appended zero); bmap scatters per-partition
        # boundary contributions into the global Schur system (dummy slot
        # n_b lands in a discarded buffer row).
        l2g = np.full((P, n_loc), n_vars, dtype=np.int32)
        g2l = [dict() for _ in range(P)]
        bmap = np.full((P, kb), n_b, dtype=np.int32)
        int_map = np.full((P, m), n_vars, dtype=np.int32)  # scatter d_i out
        for p in range(P):
            for i, g in enumerate(interior[p]):
                l2g[p, i] = g
                g2l[p][g] = i
                int_map[p, i] = g
            for j, g in enumerate(local_b[p]):
                l2g[p, m + j] = g
                g2l[p][g] = m + j
                bmap[p, j] = b_slot[g]
        self.l2g = l2g
        self.bmap = bmap
        self.int_map = int_map

        # Banded-boundary structure: half-bandwidth = widest within-part
        # boundary span under the natural ordering (per-part Schur blocks
        # only couple a part's OWN boundary slots, so the lower band with
        # this bw captures S exactly). Static scatter indices map each
        # (part, k, j) block entry to (row slot, band offset); upper-
        # triangle and dummy entries get out-of-range offsets and are
        # dropped by the scatter.
        spans = [
            int(r.max() - r.min())
            for p in range(P)
            for r in (bmap[p][bmap[p] < n_b],)
            if r.size
        ]
        self.band_bw = bw = max(spans, default=0)
        rows = np.repeat(bmap[:, :, None], kb, axis=2)  # row slot of (k, j)
        cols = np.repeat(bmap[:, None, :], kb, axis=1)
        off = cols - rows + bw
        invalid = (rows >= n_b) | (cols >= n_b) | (off < 0) | (off > bw)
        self.band_rows = np.where(invalid, n_b, rows)
        self.band_off = np.where(invalid, bw + 1, off)  # OOB -> dropped
        self.boundary_solver = resolve_boundary_solver(
            self.boundary_solver, n_b, bw
        )
        imask = np.zeros((P, m))
        for p in range(P):
            imask[p, : len(interior[p])] = 1.0
        self.imask = imask

        # Stacked per-kind kernel blocks with local indices, for the f32
        # Jacobian pass (the f64 residual side uses self.system directly).
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
            idx = np.zeros((P, n_max, spec.nvars), dtype=np.int32)
            par = np.zeros((P, n_max, spec.nparams), dtype=np.float64)
            wgt = np.zeros((P, n_max), dtype=np.float64)
            cid = np.full((P, n_max), self.n_constraints, dtype=np.int32)
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
            # par/wgt kept in BOTH precisions: residual rows evaluate in
            # the solve dtype, Jacobians in jac_dtype (see
            # _partition_normal_eq).
            self.jblocks.append(
                (spec, idx,
                 par.astype(np.dtype(dtype)),
                 par.astype(np.dtype(self.jac_dtype)),
                 wgt.astype(np.dtype(dtype)),
                 wgt.astype(np.dtype(self.jac_dtype)), cid)
            )

        self._solve_one = None  # built lazily (jit once per topology)

    # -- the f32 partitioned normal-equation pass -------------------------

    def _partition_normal_eq(self, x):
        """Per-partition (jtj, jtr, deg) in jac_dtype at global x (f64).

        The refinement structure that makes ``precision="mixed"`` actually
        converge: residual rows evaluate in the SOLVE dtype at the true
        f64 x (coordinates of magnitude c are only representable to
        ~6e-8*c in f32 — evaluating the RHS at the f32-rounded point caps
        achievable residuals far above 1e-8; measured as a hard
        non-convergence on the 2400-var coupled fixture, whose
        coordinates reach 600). Jacobians evaluate in jac_dtype at the
        rounded point: the STEP direction only needs relative accuracy,
        exactly like ``ShardedSchurSolver._local_eval``.
        """
        jt = self.jac_dtype
        P, m, kb = self.P, self.m, self.kb
        n_loc = m + kb
        x_ext = jnp.concatenate([x, jnp.zeros((1,), self.dtype)])
        x_loc = x_ext[self.l2g]  # (P, n_loc) in solve dtype
        x_loc_j = x_loc.astype(jt)
        jtj = jnp.zeros((P, n_loc, n_loc), jt)
        jtr = jnp.zeros((P, n_loc), jt)
        deg = jnp.zeros((self.n_constraints + 1,), jnp.bool_)

        def gather(xl, idx):
            return jnp.take_along_axis(
                xl[:, :, None], idx.transpose(0, 2, 1), axis=1
            ).transpose(0, 2, 1)  # (P, nb, nv)

        for spec, idx, par64, par_j, wgt64, wgt_j, cid in self.jblocks:
            fn = spec.fn

            def jac_only(vv, pp, fn=fn):
                return jax.jacfwd(lambda z: fn(z, pp)[0])(vv)

            res64, dg = jax.vmap(jax.vmap(fn))(
                gather(x_loc, idx), jnp.asarray(par64))
            jac = jax.vmap(jax.vmap(jac_only))(
                gather(x_loc_j, idx), jnp.asarray(par_j))
            wres = (res64 * jnp.asarray(wgt64)[:, :, None]).astype(jt)
            w = jnp.asarray(wgt_j)
            wjac = jac * w[:, :, None, None]
            contrib = jnp.einsum("pndk,pndl->pnkl", wjac, wjac, precision=_HIGHEST)
            jtj = jtj.at[
                jnp.arange(P)[:, None, None, None],
                idx[:, :, :, None],
                idx[:, :, None, :],
            ].add(contrib)
            jtr = jtr.at[jnp.arange(P)[:, None, None], idx].add(
                jnp.einsum("pndk,pnd->pnk", wjac, wres, precision=_HIGHEST)
            )
            if spec.can_degenerate:
                # Padded lanes carry cid == n_constraints, so their flags
                # land in the dummy slot sliced off below — no weight mask
                # needed. Real weight-0 constraints DO flag (same contract
                # as residual_and_flags / the reference, which evaluates
                # every constraint regardless of its weight).
                deg = deg.at[cid].max(dg)
        return jtj, jtr, deg[: self.n_constraints]

    def _schur_step(self, x, lam):
        """One damped partitioned-Schur step at global x. Returns
        (d (n_vars,) in solve dtype, fail, deg_j)."""
        jt = self.jac_dtype
        P, m, kb, n_b = self.P, self.m, self.kb, self.n_b
        jtj, jtr, deg_j = self._partition_normal_eq(x)
        # No f32 damping floor here (contrast solver._damping_floor): big
        # coupled systems legitimately have softest-mode curvatures near
        # f32 round-off (a P-part chain's smallest JtJ eigenvalue scales
        # like 1/P^2 ~ 3e-6 at 600 parts), and flooring lambda there
        # MEASURABLY slows convergence (2 -> 11 LM iterations on the
        # 600-line coupled fixture). A genuinely singular interior just
        # pays the reference's reject-and-redamp cascade (newton.rs:96-99).
        lam_j = lam.astype(jt)
        imask = jnp.asarray(self.imask, jt)  # (P, m)
        eye_m = jnp.eye(m, dtype=jt)
        # Unit diagonal on padded interior slots keeps A_pp SPD.
        a_ii = (
            jtj[:, :m, :m]
            + lam_j * eye_m * imask[:, None, :]
            + (1.0 - imask)[:, :, None] * eye_m
        )
        a_ib = jtj[:, :m, m:]  # (P, m, kb)
        a_bb = jtj[:, m:, m:]  # (P, kb, kb)
        b_i = -jtr[:, :m]
        b_b = -jtr[:, m:]

        # Interiors are a heavily-batched small-matrix regime (P vmapped
        # solves, x B when fleets vmap over this): 24 < n_loc <= 64 routes
        # to the matmul-free column-sweep tier; <= 24 is unchanged.
        if n_b:
            # ONE interior factorization per step: pack b_i alongside A_ib
            # so u (= A_ii^-1 b_i) and W (= A_ii^-1 A_ib) fall out of a
            # single multi-RHS solve, and back-substitute the boundary step
            # algebraically (d_i = u - W d_b) instead of a third solve —
            # the substitution sweeps on (P, m, m) were the remaining
            # duplicated work after XLA CSE merged the factorizations.
            packed = jnp.concatenate([b_i[:, :, None], a_ib], axis=2)
            sol, fail_i = jax.vmap(spd_solve_multi_batched)(a_ii, packed)
            u = sol[:, :, 0]
            w_mat = sol[:, :, 1:]
            rhs_contrib = b_b - jnp.einsum("pmk,pm->pk", a_ib, u)
            rhs_buf = jnp.zeros((n_b + 1,), jt).at[self.bmap].add(rhs_contrib)
            rhs = rhs_buf[:n_b]
            if self.boundary_solver == "cg":
                from .hier import _pcg

                bmap = jnp.asarray(self.bmap)

                def s_matvec(v):
                    v_ext = jnp.concatenate([v, jnp.zeros((1,), jt)])
                    v_loc = v_ext[bmap]  # (P, kb)
                    t = jnp.einsum("pkj,pj->pk", a_bb, v_loc)
                    t = t - jnp.einsum(
                        "pmk,pm->pk", a_ib,
                        jnp.einsum("pmk,pk->pm", w_mat, v_loc))
                    buf = jnp.zeros((n_b + 1,), jt).at[bmap].add(t)
                    return buf[:n_b] + lam_j * v

                diag_local = jnp.einsum("pkk->pk", a_bb) - jnp.einsum(
                    "pmk,pmk->pk", a_ib, w_mat)
                diag_s = jnp.zeros((n_b + 1,), jt).at[bmap].add(
                    diag_local)[:n_b] + lam_j
                minv = jnp.where(diag_s > 0, 1.0 / diag_s,
                                 jnp.ones_like(diag_s))
                tol = self.cg_tol * jnp.sqrt(jnp.vdot(rhs, rhs))
                d_b = _pcg(s_matvec, rhs, minv, tol, self.cg_max_iters)
                fail_b = jnp.asarray(False)
            elif self.boundary_solver == "banded":
                from ..ops.banded import banded_spd_solve

                s_contrib = a_bb - jnp.einsum("pmk,pmj->pkj", a_ib, w_mat)
                band = jnp.zeros((n_b + 1, self.band_bw + 1), jt)
                band = band.at[
                    jnp.asarray(self.band_rows), jnp.asarray(self.band_off)
                ].add(s_contrib, mode="drop")
                band = band[:n_b].at[:, self.band_bw].add(lam_j)
                d_b, fail_b = banded_spd_solve(band, rhs)
            else:
                s_contrib = a_bb - jnp.einsum("pmk,pmj->pkj", a_ib, w_mat)
                s_buf = jnp.zeros((n_b + 1, n_b + 1), jt)
                s_buf = s_buf.at[
                    self.bmap[:, :, None], self.bmap[:, None, :]
                ].add(s_contrib)
                s_mat = s_buf[:n_b, :n_b] + lam_j * jnp.eye(n_b, dtype=jt)
                d_b, fail_b = spd_solve(s_mat, rhs)
            d_b_ext = jnp.concatenate([d_b, jnp.zeros((1,), jt)])
            d_b_loc = d_b_ext[self.bmap]  # (P, kb)
            d_i = u - jnp.einsum("pmk,pk->pm", w_mat, d_b_loc)
        else:
            u, fail_i = jax.vmap(spd_solve_batched)(a_ii, b_i)
            fail_b = jnp.asarray(False)
            d_b = jnp.zeros((0,), jt)
            d_i = u
        fail = jnp.any(fail_i) | fail_b
        d_i = d_i * imask
        # Scatter the step back to global variable order (dummy slot
        # n_vars absorbs padded interior lanes).
        d = jnp.zeros((self.n_vars + 1,), self.dtype)
        d = d.at[self.int_map].add(d_i.astype(self.dtype))
        if n_b:
            d = d.at[jnp.asarray(self.boundary, jnp.int32)].add(
                d_b.astype(self.dtype)
            )
        d = d[: self.n_vars]
        d = jnp.where(fail, jnp.zeros_like(d), d)
        return d, fail, deg_j

    # -- public solve ------------------------------------------------------

    def _build(self):
        c = self.config
        system = self.system

        def solve_one(x0, rtol, stol, lam0):
            # Accelerator matmuls on f32 inputs may default to reduced-
            # precision multiplies (TF32 on the GPU) — enough to keep the
            # mixed path's Schur algebra from ever reaching the f64 1e-8
            # target. Bake full-f32 precision into the trace.
            with jax.default_matmul_precision("highest"):
                state = _init_state(system, x0, lam0,
                                    lam_dtype=self.jac_dtype)

                def step(s):
                    return self._schur_step(s.x, s.lam)

                final, res_conv = _lm_while_loop(
                    state, lambda xx: system.residual_and_flags(xx), step,
                    c.max_iterations, jnp.asarray(rtol, self.dtype),
                    jnp.asarray(stol, self.dtype), boundary_parity=True,
                )
                res = _reference_result(final, res_conv, c.max_iterations)
                sat = system.constraint_satisfaction(res.x)
                return res, sat

        self._solve_one = jax.jit(solve_one)
        self._solve_many = jax.jit(
            jax.vmap(solve_one, in_axes=(0, None, None, None))
        )

    def solve(self, x0) -> dict:
        """Solve one system from ``x0`` (n_vars,). Returns the same outcome
        dict shape as ``ShardedSchurSolver.solve``."""
        if self._solve_one is None:
            self._build()
        c = self.config
        res, sat = self._solve_one(
            jnp.asarray(x0), c.residual_tolerance, c.step_tolerance,
            c.initial_lambda,
        )
        return dict(
            x=np.asarray(res.x),
            iterations=int(res.iterations),
            converged=bool(res.converged),
            satisfied=np.asarray(sat),
            degenerate=np.asarray(res.deg),
            n_boundary=self.n_b,
            n_interior=self.m,
            n_parts=self.P,
        )

    def solve_batch(self, x0s) -> LMResult:
        """Vmapped fleet solve over (B, n_vars) initial guesses — a fleet of
        same-topology COUPLED systems. Returns (LMResult, satisfied)."""
        if self._solve_one is None:
            self._build()
        c = self.config
        return self._solve_many(
            jnp.asarray(x0s), c.residual_tolerance, c.step_tolerance,
            c.initial_lambda,
        )
