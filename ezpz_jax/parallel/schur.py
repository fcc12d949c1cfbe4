"""Sharded single-system solve via Schur-complement reduction.

Model parallelism for a constraint solver (SURVEY.md
section 2): partition the variable vector across a 1-D device mesh, keep the
(few) variables touched by cross-partition constraints in a replicated
boundary set B, and solve the damped normal equations per LM iteration with
a Schur complement:

    A = [[A_II, A_IB],    A_II block-diagonal across devices (interiors),
         [A_BI, A_BB]]    B replicated

    per device i:  W_i = A_ii^-1 A_ib,  u_i = A_ii^-1 b_i
    S    = psum(A_bb_part - A_ib^T W_i) + lambda*I     (ICI all-reduce)
    x_b  = S^-1 (psum(b_b_part - A_ib^T u_i))          (replicated solve)
    x_i  = A_ii^-1 (b_i - A_ib x_b)                    (local back-subst)

Everything runs under ``shard_map`` in one jitted LM ``while_loop``;
accept/reject and convergence use psum/pmax so every device takes identical
branches. Communication per iteration: one psum of an (n_b+1, n_b+1)-ish
packet — independent of interior size.

Constraints whose variables span partitions ("coupling constraints") only
ever touch boundary variables by construction, and are distributed
round-robin across devices for load balance.
"""

from __future__ import annotations

import os
from collections import defaultdict
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import LM_LAMBDA_DECR, LM_LAMBDA_INCR, Config
from ..constraints import Constraint
from ..models.compiled import EPSILON
from ..ops.kernels import KERNELS
from ..ops.linalg import spd_solve, spd_solve_multi
from ..solver import _cg

# f32 contractions on the mixed paths must not drop to TF32 or bf16
# multiplies, which would keep the f64-verified residual from 1e-8.
_HIGHEST = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Partitioning + padded per-device compilation


@dataclass
class ShardedLayout:
    n_vars: int
    n_devices: int
    interior: List[List[int]]  # per device, global ids (unpadded)
    boundary: List[int]  # global ids, replicated
    n_i: int  # padded interior size
    n_b: int
    # per device: local slot -> global id (padded slots map to -1)
    local_to_global: np.ndarray  # (D, n_i + n_b)


def resolve_boundary_solver(
    requested: str, n_b: int, band_bw: int, banded_ok: bool = True
) -> str:
    """Resolve ``boundary_solver="auto"`` to a concrete method from the
    coupling STRUCTURE (all sizes known at build time — no tracing):

    * ``banded`` when the Schur complement's half-bandwidth is a small
      fraction of ``n_b`` (chain-like coupling: ``4*(bw+1) <= n_b``):
      exact direct solve in O(n_b*bw^2), asymptotically beats both
      alternatives, and — unlike CG — keeps LM iteration counts identical
      to the dense path (the step is exact).
    * ``dense`` for small boundaries (``n_b <= 256``): one Cholesky of a
      small matrix is a single fused XLA op whose O(n_b^3) term is below
      dispatch noise at this size, and the step stays exact.
    * ``cg`` otherwise (large, non-chain couplings): Jacobi-PCG matvecs
      never materialize S; the LM accept/reject loop absorbs the inexact
      step (inexact Newton).

    The thresholds are structural, not measured cutovers: banded's win
    over dense grows like (n_b/bw)^2 and CG's win over dense grows with
    n_b, so the exact crossover barely matters — each branch is chosen
    where it is asymptotically safe.
    """
    if requested != "auto":
        return requested
    if banded_ok and n_b > 0 and band_bw > 0 and 4 * (band_bw + 1) <= n_b:
        return "banded"
    if n_b <= 256:
        return "dense"
    return "cg"


def partition_variables(
    constraints: Sequence[Constraint], n_vars: int, n_devices: int,
    block_of_var: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, List[int]]:
    """Home device per variable (contiguous ranges by default) and the
    boundary set: every variable touched by a constraint spanning devices."""
    if block_of_var is None:
        block_of_var = np.minimum(
            np.arange(n_vars) * n_devices // max(n_vars, 1), n_devices - 1
        )
    block_of_var = np.asarray(block_of_var)
    boundary: set = set()
    for c in constraints:
        ids = c.dependent_variable_ids()
        homes = {int(block_of_var[v]) for v in ids}
        if len(homes) > 1:
            boundary.update(ids)
    return block_of_var, sorted(boundary)


@dataclass
class _StackedBlock:
    spec: object
    idx: np.ndarray  # (D, n, k) int32 local indices
    par: np.ndarray  # (D, n, p)
    weight: np.ndarray  # (D, n)
    cid: np.ndarray  # (D, n) local constraint slot (dummy -> n_cons_max)


class ShardedSchurSolver:
    """Shard ONE coupled system's variables across a device mesh; each LM
    step solves interiors locally and reduces the coupling through a Schur
    complement with one ``psum`` per iteration.

    Chain two fixed-base distance sketches coupled by a ``ScalarEqual``
    across the partition cut, sharded over the (faked, in CI) device mesh:

    >>> import numpy as np
    >>> from ezpz_jax import Constraint, DatumPoint
    >>> from ezpz_jax.parallel import ShardedSchurSolver
    >>> p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    >>> r, s = DatumPoint(4, 5), DatumPoint(6, 7)
    >>> cs = [Constraint.Fixed(0, 0.0), Constraint.Fixed(1, 0.0),
    ...       Constraint.Distance(p, q, 2.0),
    ...       Constraint.Fixed(4, 1.0), Constraint.Fixed(5, 0.0),
    ...       Constraint.Distance(r, s, 2.0),
    ...       Constraint.ScalarEqual(3, 7)]  # couples the halves
    >>> out = ShardedSchurSolver(cs, 8).solve(
    ...     np.array([0.0, 0.0, 1.4, 1.5, 1.0, 0.0, 2.4, 1.6]))
    >>> out["converged"] and out["n_boundary"] > 0
    True
    """

    def __init__(
        self,
        constraints: Sequence[Constraint],
        n_vars: int,
        mesh: Optional[Mesh] = None,
        weights: Optional[Sequence[float]] = None,
        config: Config = Config(),
        block_of_var: Optional[np.ndarray] = None,
        dtype=jnp.float64,
        precision: str = "f64",
        boundary_solver: str = "dense",
        cg_tol: Optional[float] = None,
        cg_max_iters: int = 400,
    ):
        """``precision="mixed"``: per-iteration inexact Newton —
        residuals, norms, and accept/reject stay f64, but Jacobians, the
        normal-equation blocks, the Schur reduction, and every
        factorization run in f32. Near
        the solution |step| ~ |residual|, so f32 *relative* error on the
        step is far below the f64-verified 1e-8 target; far from it, the
        accept/reject loop guards progress exactly as in the f64 path.

        ``boundary_solver``: how the coupling (Schur) system is solved.

        * ``"dense"`` (default) — psum the full (n_b, n_b) Schur matrix and
          Cholesky it, replicated on every device. Exact; right for small
          boundaries.
        * ``"cg"`` — DISTRIBUTED matrix-free conjugate gradients: the
          (n_b, n_b) Schur matrix is never materialized anywhere. Each CG
          matvec applies every device's local contribution
          ``A_BB_d v - A_dB^T (A_dd^-1 A_dB) v`` and psums the (n_b,)
          result — one small collective per CG step, memory O(n_i * n_b)
          per device instead of a replicated O(n_b^2). This removes the
          quadratic boundary wall for large-boundary partitions (2-D grid
          sketches, fine-grained meshes); the damped Schur complement is
          SPD, so CG needs no failure path. ``cg_tol`` is RELATIVE to
          |rhs| (inexact Newton: the LM accept/reject loop absorbs the
          inexactness; tighten it if iteration-count parity with the dense
          path matters). Default (``None``): picked for the working
          dtype — 1e-12 when the linear algebra runs in f64, 1e-5 in
          f32 (just above where f32 CG residuals stagnate).
          A fixed 1e-12 relative target is unreachable in f32 (the CG
          residual stagnates near ~1e-7 |rhs|), silently burning the full
          ``cg_max_iters`` matvecs + psums on every LM iteration."""
        if mesh is None:
            mesh = Mesh(np.array(jax.devices()), ("d",))
        assert precision in ("f64", "mixed"), precision
        assert boundary_solver in ("dense", "cg", "auto"), boundary_solver
        # "auto" resolves once n_b is known (below); this solver has no
        # banded path, so resolution only picks dense vs cg.
        self.boundary_solver = boundary_solver
        if cg_tol is None:
            cg_tol = 1e-5 if precision == "mixed" else 1e-12
        self.cg_tol = float(cg_tol)
        self.cg_max_iters = int(cg_max_iters)
        self.mesh = mesh
        D = mesh.devices.size
        self.config = config
        self.dtype = dtype
        self.precision = precision
        # dtype of the linear-algebra side (J, JtJ, Schur, factorizations).
        self.jac_dtype = jnp.float32 if precision == "mixed" else dtype
        self.n_vars = n_vars
        self.n_constraints = len(constraints)
        if weights is None:
            weights = [1.0] * len(constraints)

        block_of_var, boundary = partition_variables(
            constraints, n_vars, D, block_of_var
        )
        bset = set(boundary)
        interior = [
            [v for v in range(n_vars) if block_of_var[v] == d and v not in bset]
            for d in range(D)
        ]
        n_i = max((len(iv) for iv in interior), default=0)
        n_b = len(boundary)
        self.n_i, self.n_b = n_i, n_b
        self.boundary_solver = resolve_boundary_solver(
            self.boundary_solver, n_b, 0, banded_ok=False
        )

        # Local index maps.
        local_to_global = -np.ones((D, n_i + n_b), dtype=np.int64)
        global_to_local = [dict() for _ in range(D)]
        for d in range(D):
            for i, g in enumerate(interior[d]):
                local_to_global[d, i] = g
                global_to_local[d][g] = i
            for j, g in enumerate(boundary):
                local_to_global[d, n_i + j] = g
                global_to_local[d][g] = n_i + j
        self.layout = ShardedLayout(
            n_vars=n_vars, n_devices=D, interior=interior, boundary=boundary,
            n_i=n_i, n_b=n_b, local_to_global=local_to_global,
        )

        # Home each constraint: local constraints to their variables' device,
        # coupling constraints round-robin.
        per_device: List[List[int]] = [[] for _ in range(D)]
        rr = 0
        for cid, c in enumerate(constraints):
            ids = c.dependent_variable_ids()
            homes = {int(block_of_var[v]) for v in ids}
            if len(homes) == 1 and not set(ids) <= bset:
                per_device[homes.pop()].append(cid)
            elif len(homes) == 1:
                # Touches only boundary vars but within one home: still local.
                per_device[homes.pop()].append(cid)
            else:
                per_device[rr % D].append(cid)
                rr += 1

        n_cons_max = max((len(p) for p in per_device), default=0)
        self.n_cons_max = n_cons_max
        # Map (device, local constraint slot) -> global cid (-1 for padding).
        self.cons_map = -np.ones((D, n_cons_max), dtype=np.int64)
        for d in range(D):
            for s, cid in enumerate(per_device[d]):
                self.cons_map[d, s] = cid

        # Lower per device, grouped by kind; then pad to uniform counts.
        per_dev_kinds: List[Dict[str, dict]] = []
        for d in range(D):
            slots: Dict[str, dict] = {}
            for s, cid in enumerate(per_device[d]):
                for inst in constraints[cid].lower():
                    spec = KERNELS[inst.kernel]
                    kslot = slots.setdefault(
                        inst.kernel, {"idx": [], "par": [], "w": [], "cid": []}
                    )
                    kslot["idx"].append(
                        tuple(global_to_local[d][v] for v in inst.var_ids)
                    )
                    kslot["par"].append(inst.params)
                    kslot["w"].append(weights[cid])
                    kslot["cid"].append(s)
            per_dev_kinds.append(slots)

        all_kinds = sorted({k for slots in per_dev_kinds for k in slots})
        self.blocks: List[_StackedBlock] = []
        for kind in all_kinds:
            spec = KERNELS[kind]
            n_max = max(len(per_dev_kinds[d].get(kind, {"idx": []})["idx"]) for d in range(D))
            idx = np.zeros((D, n_max, spec.nvars), dtype=np.int32)
            par = np.zeros((D, n_max, spec.nparams), dtype=np.float64)
            wgt = np.zeros((D, n_max), dtype=np.float64)  # dummies weight 0
            cid = np.full((D, n_max), n_cons_max, dtype=np.int32)  # dummy slot
            for d in range(D):
                kslot = per_dev_kinds[d].get(kind)
                if not kslot:
                    continue
                n = len(kslot["idx"])
                if n:
                    idx[d, :n] = np.asarray(kslot["idx"], dtype=np.int32)
                    par[d, :n] = np.asarray(kslot["par"], dtype=np.float64).reshape(
                        n, spec.nparams
                    )
                    wgt[d, :n] = kslot["w"]
                    cid[d, :n] = kslot["cid"]
            self.blocks.append(_StackedBlock(spec, idx, par, wgt, cid))

        # Padded-interior mask: 1.0 on real slots, 0.0 on padding.
        self.interior_mask = np.zeros((D, n_i), dtype=np.float64)
        for d in range(D):
            self.interior_mask[d, : len(interior[d])] = 1.0

        self._build_solver()

    # -- device-side evaluation over local x ------------------------------

    def _local_eval(self, x_local, blocks_dev, want_jac: bool):
        """Residual (+ JtJ/Jtr) over this device's constraints.

        ``x_local``: (n_i + n_b,). ``blocks_dev``: per-block (idx, par, w, cid)
        with the device axis already sliced off.
        """
        n_local = self.n_i + self.n_b
        n_slots = self.n_cons_max + 1
        jt = self.jac_dtype  # f32 under precision="mixed", else self.dtype
        r2 = jnp.zeros((), self.dtype)
        rinf = jnp.zeros((), self.dtype)
        deg = jnp.zeros((n_slots,), jnp.bool_)
        worst = jnp.zeros((n_slots,), self.dtype)
        jtj = jnp.zeros((n_local, n_local), jt) if want_jac else None
        jtr = jnp.zeros((n_local,), jt) if want_jac else None
        for blk, (idx, par, w, cid) in zip(self.blocks, blocks_dev):
            fn = blk.spec.fn
            v = x_local[idx]
            # Residuals ALWAYS evaluate in the solve dtype (f64): the 1e-8
            # verification depends on it. Jacobians may evaluate in f32
            # (mixed): with |r| small, f32 relative error on J produces a
            # negligible absolute step error (inexact Newton).
            if want_jac and jt == self.dtype:
                # Same dtype: one fused jacfwd-with-value evaluation.
                def jac_val(vv, pp, fn=fn):
                    def wrapped(z):
                        res_, dg_ = fn(z, pp)
                        return res_, (res_, dg_)
                    return jax.jacfwd(wrapped, has_aux=True)(vv)

                jac, (res, dg) = jax.vmap(jac_val)(v, par)
                wres = res * w[:, None]
            else:
                res, dg = jax.vmap(fn)(v, par)
                wres = res * w[:, None]
                if want_jac:
                    def jac_only(vv, pp, fn=fn):
                        return jax.jacfwd(lambda z: fn(z, pp)[0])(vv)

                    jac = jax.vmap(jac_only)(v.astype(jt), par.astype(jt))
            if want_jac:
                wjac = jac * w.astype(jt)[:, None, None]
                jtj = jtj.at[idx[:, :, None], idx[:, None, :]].add(
                    jnp.einsum("ndk,ndl->nkl", wjac, wjac, precision=_HIGHEST)
                )
                jtr = jtr.at[idx].add(
                    jnp.einsum("ndk,nd->nk", wjac, wres.astype(jt), precision=_HIGHEST)
                )
            r2 = r2 + jnp.sum(wres * wres)
            rinf = jnp.maximum(rinf, jnp.max(jnp.abs(wres)) if wres.size else 0.0)
            live = w > 0
            if blk.spec.can_degenerate:  # constant-False flags skip the scatter
                deg = deg.at[cid].max(dg & live)
            worst = worst.at[cid].max(jnp.max(jnp.abs(res), axis=1) * live)
        return r2, rinf, deg, worst, jtj, jtr

    def _build_solver(self):
        mesh = self.mesh
        n_i, n_b = self.n_i, self.n_b
        dtype = self.dtype
        max_iterations = self.config.max_iterations
        imask = jnp.asarray(self.interior_mask)  # (D, n_i)

        block_arrays = tuple(
            (jnp.asarray(b.idx), jnp.asarray(b.par), jnp.asarray(b.weight),
             jnp.asarray(b.cid))
            for b in self.blocks
        )

        def device_fn(x_i, x_b, imask_d, blocks_dev, rtol, stol, lam0, it0,
                      deg0_in, it_limit):
            # Shapes inside shard_map: x_i (1, n_i), x_b (n_b,), blocks (1, ...).
            # ``it0``/``deg0_in``/``it_limit`` support segmented (checkpoint/
            # resume) driving: a fresh solve passes it0=0, deg0_in=False,
            # it_limit=max_iterations; a resumed segment passes the saved
            # iteration count and degenerate flags and a nearer limit.
            x_i = x_i[0]
            imask_d = imask_d[0]
            deg0_in = deg0_in[0]
            blocks_dev = tuple(
                (idx[0], par[0], w[0], cid[0]) for idx, par, w, cid in blocks_dev
            )

            def x_local(xi, xb):
                return jnp.concatenate([xi, xb])

            # Every collective on the mesh is a full-device barrier, so the
            # residual evaluation's psum(r2) + pmax(rinf) — and, in the
            # body, the (fail, step-inf) pmax — are packed into ONE psum:
            # scalars that need a SUM ride directly, scalars that need a
            # MAX ride in a one-hot device slot and take jnp.max after the
            # reduction. 2 collectives per LM iteration total (this one and
            # the Schur-matrix psum), down from 4.
            D_mesh = mesh.devices.size
            dev_onehot = jnp.arange(D_mesh) == jax.lax.axis_index("d")

            def global_eval(xi, xb, fail_local=None, step_local=None):
                r2, rinf, deg, worst, _, _ = self._local_eval(
                    x_local(xi, xb), blocks_dev, want_jac=False
                )
                zero = jnp.zeros((), dtype)
                fl = zero if fail_local is None else fail_local
                sl = zero if step_local is None else step_local
                vec = jnp.concatenate([
                    jnp.stack([r2, fl]),
                    jnp.where(dev_onehot, rinf, zero),
                    jnp.where(dev_onehot, sl, zero),
                ])
                packed = jax.lax.psum(vec, "d")
                return (
                    packed[0],                        # global r2
                    packed[1] > 0,                    # any-device fail
                    jnp.max(packed[2:2 + D_mesh]),    # global rinf
                    jnp.max(packed[2 + D_mesh:]),     # global step inf
                    deg,
                    worst,
                )

            r2_0, _f0, rinf_0, _s0, deg0, _worst0 = global_eval(x_i, x_b)

            # The linear-algebra side lives in jac_dtype (f32 when mixed).
            jt = self.jac_dtype
            eye_i = jnp.eye(n_i, dtype=jt)
            eye_b = jnp.eye(n_b, dtype=jt)
            imask_j = imask_d.astype(jt)
            pad_diag = (1.0 - imask_j) * eye_i  # unit diagonal on padded slots

            state = dict(
                x_i=x_i,
                x_b=x_b,
                r2=r2_0,
                rinf=rinf_0,
                lam=jnp.asarray(lam0, dtype),
                it=jnp.asarray(it0, jnp.int32),
                done=jnp.asarray(False),
                converged=jnp.asarray(False),
                iterations=jnp.asarray(0, jnp.int32),
                deg=deg0 | deg0_in,
            )

            # Residual check in ``cond`` (see solver.solve_lm): a residual-
            # converged solve never pays for a detection pass of the body.
            def cond(s):
                return (~s["done"]) & (s["it"] < it_limit) & (s["rinf"] > rtol)

            def body(s):
                _r2, _ri, deg_j, _w, jtj, jtr = self._local_eval(
                    x_local(s["x_i"], s["x_b"]), blocks_dev, want_jac=True
                )
                # No f32 damping floor here: large coupled systems have
                # softest-mode curvatures near f32 round-off, and flooring
                # lambda there slows convergence (see block_schur.py).
                lam_j = s["lam"].astype(jt)
                b_i = -jtr[:n_i]
                b_b = -jtr[n_i:]
                a_ii = jtj[:n_i, :n_i] + lam_j * eye_i * imask_j[None, :] + pad_diag
                a_ib = jtj[:n_i, n_i:]
                a_bb_part = jtj[n_i:, n_i:]

                if n_b:
                    # ONE interior factorization: b_i rides as an extra RHS
                    # next to A_ib, so u and W share the factorization and
                    # substitution sweep; the interior back-substitution
                    # after the boundary solve is then the algebraic
                    # identity d_i = u - W d_b (a matvec) instead of a
                    # third triangular solve.
                    packed_rhs = jnp.concatenate([b_i[:, None], a_ib], 1)
                    sol, fail_i = spd_solve_multi(a_ii, packed_rhs)
                    u = sol[:, 0]
                    w_mat = sol[:, 1:]
                    rhs_part = b_b - a_ib.T @ u
                    if self.boundary_solver == "cg":
                        rhs = jax.lax.psum(rhs_part, "d")

                        # Distributed boundary solve: CG state is replicated
                        # (n_b,) vectors; only the matvec is distributed —
                        # one (n_b,) psum per CG iteration, no (n_b, n_b)
                        # matrix anywhere.
                        def s_matvec(v):
                            local = a_bb_part @ v - a_ib.T @ (w_mat @ v)
                            return jax.lax.psum(local, "d") + lam_j * v

                        tol = self.cg_tol * jnp.sqrt(jnp.vdot(rhs, rhs))
                        d_b = _cg(s_matvec, rhs, jnp.zeros_like(rhs),
                                  tol, self.cg_max_iters)
                        fail_b = jnp.asarray(False)
                    else:
                        # ONE fused psum for the Schur matrix AND its rhs
                        # (rhs rides as an extra row): every collective
                        # launch is serialization overhead the single-chip
                        # path doesn't pay.
                        s_part = a_bb_part - a_ib.T @ w_mat
                        packed = jax.lax.psum(
                            jnp.concatenate([s_part, rhs_part[None, :]], 0),
                            "d")
                        s_mat = packed[:n_b] + lam_j * eye_b
                        rhs = packed[n_b]
                        d_b, fail_b = spd_solve(s_mat, rhs)
                    d_i = u - w_mat @ d_b
                    step_inf_b = jnp.max(jnp.abs(d_b))
                else:
                    u, fail_i = spd_solve(a_ii, b_i)
                    fail_b = jnp.asarray(False)
                    d_b = jnp.zeros((0,), jt)
                    d_i = u
                    step_inf_b = jnp.zeros((), jt)
                # Steps upcast to the solve dtype before touching x.
                d_i = d_i.astype(dtype) * imask_d
                d_b = d_b.astype(dtype)

                # n_i == 0 (every variable on the boundary — tiny systems
                # over many devices): no interior step to measure.
                step_inf_i = (
                    jnp.max(jnp.abs(d_i)) if n_i else jnp.zeros((), dtype)
                )
                # The (fail, step-inf) reduction rides in the trial
                # evaluation's packed psum instead of its own pmax. A
                # failed factorization's step is already zero-filled
                # (spd_solve sanitizes its output), and d_b is computed
                # from psum-replicated data so the trial point stays
                # consistent across devices even before the global fail
                # flag is known; ``accept`` still gates on the global
                # flag, so a reject-under-failure leaves the state exactly
                # as the eager pmax did (trial-point deg flags accumulate
                # from rejected steps either way).
                fail_local = jnp.maximum(fail_i, fail_b).astype(dtype)
                step_local = jnp.maximum(step_inf_i, step_inf_b.astype(dtype))

                x_i_new = s["x_i"] + d_i
                x_b_new = s["x_b"] + d_b
                r2_new, fail, rinf_new, step_inf, deg_r, _wn = global_eval(
                    x_i_new, x_b_new, fail_local, step_local)
                accept = jnp.logical_and(~fail, r2_new < s["r2"])

                out = dict(s)
                out["x_i"] = jnp.where(accept, x_i_new, s["x_i"])
                out["x_b"] = jnp.where(accept, x_b_new, s["x_b"])
                out["r2"] = jnp.where(accept, r2_new, s["r2"])
                out["rinf"] = jnp.where(accept, rinf_new, s["rinf"])
                out["lam"] = jnp.where(
                    accept, s["lam"] * LM_LAMBDA_DECR, s["lam"] * LM_LAMBDA_INCR
                )
                out["deg"] = s["deg"] | deg_j | deg_r
                step_conv = (~fail) & (step_inf <= stol)
                out["done"] = step_conv
                out["converged"] = s["converged"] | step_conv
                out["iterations"] = jnp.where(step_conv, s["it"], s["iterations"])
                out["it"] = s["it"] + 1
                return out

            final = jax.lax.while_loop(cond, body, state)
            res_conv = final["rinf"] <= rtol
            converged = final["converged"] | res_conv
            # On budget exhaustion report the limit actually in force this
            # segment (``it_limit``), not the closure constant: a segmented
            # (checkpoint/resume) run would otherwise report
            # ``max_iterations`` after every 5-iteration slice.
            iterations = jnp.where(
                final["done"],
                final["iterations"],
                jnp.where(res_conv, final["it"],
                          jnp.asarray(it_limit, jnp.int32)),
            )
            # Final satisfaction check (unweighted residuals, EPSILON).
            # Satisfaction is judged per-device over LOCAL constraints, so
            # this evaluation needs no collective at all.
            _, _, _degf, worst_f, _, _ = self._local_eval(
                x_local(final["x_i"], final["x_b"]), blocks_dev,
                want_jac=False,
            )
            sat = worst_f < EPSILON
            return (
                final["x_i"][None, :],
                final["x_b"],
                iterations,
                converged,
                final["deg"][None, :],
                sat[None, :],
                final["lam"],
                final["it"],
                final["done"] | res_conv,
            )

        from jax import shard_map

        n_blk = len(self.blocks)
        blk_specs = tuple((P("d"), P("d"), P("d"), P("d")) for _ in range(n_blk))
        sharded = shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(P("d"), P(), P("d"), blk_specs, P(), P(), P(), P(),
                      P("d"), P()),
            out_specs=(P("d"), P(), P(), P(), P("d"), P("d"), P(), P(), P()),
            check_vma=False,
        )
        self._block_arrays = block_arrays
        self._imask = imask

        # Accelerator matmuls on f32 inputs may default to reduced-precision
        # multiplies (TF32 on the GPU), far too coarse for the mixed path's
        # Schur algebra. Bake full-precision matmuls into the trace; no-op
        # on CPU.
        def sharded_hp(*args):
            with jax.default_matmul_precision("highest"):
                return sharded(*args)

        self._sharded = jax.jit(sharded_hp)

    def _scatter_x(self, x0) -> Tuple[np.ndarray, np.ndarray]:
        D = self.layout.n_devices
        x_i0 = np.zeros((D, self.n_i))
        for d in range(D):
            ids = self.layout.interior[d]
            x_i0[d, : len(ids)] = x0[ids]
        x_b0 = np.asarray(
            [x0[g] for g in self.layout.boundary], dtype=np.float64
        ) if self.n_b else np.zeros((0,))
        return x_i0, x_b0

    @staticmethod
    def _np(a) -> np.ndarray:
        """Device array -> host numpy, multi-process safe: an array sharded
        over a multi-host mesh spans non-addressable devices, so a plain
        ``np.asarray`` raises — all-gather it to every host first. (Found by
        tests/test_multihost.py's two-process run.)"""
        if isinstance(a, jax.Array) and jax.process_count() > 1 \
                and not a.is_fully_addressable:
            from jax.experimental import multihost_utils

            return np.asarray(multihost_utils.process_allgather(a, tiled=True))
        return np.asarray(a)

    def _gather_x(self, x0, x_i, x_b) -> np.ndarray:
        x_out = np.array(x0, dtype=np.float64)
        x_i = self._np(x_i)
        for d in range(self.layout.n_devices):
            ids = self.layout.interior[d]
            x_out[ids] = x_i[d, : len(ids)]
        x_out[self.layout.boundary] = self._np(x_b)
        return x_out

    def _outcome(self, x_out, iterations, converged, deg, sat):
        satisfied = np.ones(self.n_constraints, dtype=bool)
        degenerate = np.zeros(self.n_constraints, dtype=bool)
        sat = self._np(sat)
        deg = self._np(deg)
        for d in range(self.layout.n_devices):
            for s_, cid in enumerate(self.cons_map[d]):
                if cid >= 0:
                    satisfied[cid] = sat[d, s_]
                    degenerate[cid] = deg[d, s_]
        return dict(
            x=x_out,
            iterations=int(self._np(iterations)),
            converged=bool(self._np(converged)),
            satisfied=satisfied,
            degenerate=degenerate,
            n_boundary=self.n_b,
            n_interior=self.n_i,
        )

    def _run_segment(self, x_i0, x_b0, lam0, it0, deg0, it_limit):
        c = self.config
        return self._sharded(
            jnp.asarray(x_i0),
            jnp.asarray(x_b0),
            self._imask,
            self._block_arrays,
            c.residual_tolerance,
            c.step_tolerance,
            lam0,
            it0,
            jnp.asarray(deg0),
            it_limit,
        )

    def solve(self, x0: np.ndarray):
        c = self.config
        D = self.layout.n_devices
        x_i0, x_b0 = self._scatter_x(x0)
        deg0 = np.zeros((D, self.n_cons_max + 1), dtype=bool)
        x_i, x_b, iterations, converged, deg, sat, _lam, _it, _fin = (
            self._run_segment(x_i0, x_b0, c.initial_lambda, 0, deg0,
                              c.max_iterations)
        )
        x_out = self._gather_x(x0, x_i, x_b)
        return self._outcome(x_out, iterations, converged, deg, sat)

    def solve_checkpointed(self, x0: np.ndarray, checkpoint_path: str,
                           checkpoint_every: int = 5):
        """Segmented solve with host-side checkpoint/resume.

        Runs the LM loop ``checkpoint_every`` iterations at a time, saving
        (x, lambda, iteration, degenerate flags) to ``checkpoint_path`` after
        each segment; if the file already exists for the SAME solve — same
        topology, same parameters/weights, same config, same ``x0`` — the
        solve resumes from it instead of starting over. Any mismatch (even a
        changed constraint value on an identical topology) invalidates the
        checkpoint and starts fresh. The reference has no equivalent
        (solves are milliseconds); this exists for giant sharded solves
        where preemption matters (SURVEY.md section 5 "checkpoint/resume").
        """
        from ..checkpoint import load_state, save_state, topology_fingerprint

        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
        c = self.config
        fp = topology_fingerprint(
            self.cons_map,
            self.layout.local_to_global,
            # Values, not just structure: parameters and weights per block...
            *[b.par for b in self.blocks],
            *[b.weight for b in self.blocks],
            # ...the solver configuration...
            np.asarray([c.max_iterations, c.residual_tolerance,
                        c.step_tolerance, c.initial_lambda], np.float64),
            # ...and the starting point this solve was asked to run from.
            np.asarray(x0, np.float64),
        )
        state = load_state(checkpoint_path, fp)
        if state is None:
            x_i, x_b = self._scatter_x(x0)
            lam = float(c.initial_lambda)
            it = 0
            deg = np.zeros((self.layout.n_devices, self.n_cons_max + 1), dtype=bool)
        else:
            x_i, x_b, lam, it, deg = state

        while True:
            limit = min(it + checkpoint_every, c.max_iterations)
            (x_i, x_b, iterations, converged, deg_out, sat, lam_out, it_out,
             finished) = self._run_segment(x_i, x_b, lam, it, deg, limit)
            x_i = self._np(x_i)
            x_b = self._np(x_b)
            deg = self._np(deg_out)
            lam = float(self._np(lam_out))
            it = int(self._np(it_out))
            save_state(checkpoint_path, fp, x_i, x_b, lam, it, deg)
            if bool(self._np(finished)) or it >= c.max_iterations:
                break

        # The solve is complete: remove the checkpoint so a re-invocation of
        # the same solve starts fresh (and reports the same iterations)
        # instead of "resuming" from the finished state. Stale files from a
        # DIFFERENT solve are already rejected by the fingerprint.
        try:
            os.remove(checkpoint_path)
        except OSError:
            pass

        x_out = self._gather_x(x0, x_i, x_b)
        return self._outcome(x_out, iterations, converged, deg_out, sat)
