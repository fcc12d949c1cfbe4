"""Connected-component decomposition of a constraint system.

Big sketches are usually unions of small independent subsystems — the
reference's 2000-var ``massive_parallel_system`` is 500 independent 4-var
blocks concatenated into one sparse matrix and solved serially on one core
(``gen_big_problem.py:16-27``, ``README.md:37-41``). The batched answer is
to *find* that block structure: decompose the constraint graph into connected
components, bucket components by identical topology, and solve each bucket as
one vmapped batch with per-component parameters. A 2000-var block-diagonal
system becomes a (500, 4)-batched dense solve.

Semantics: each component runs its own LM loop (per-component lambda and
convergence). Final values match a global solve wherever both converge
(residual < 1e-8); the reported ``iterations`` is the max over components.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from ..constraints import Constraint, ConstraintRequest, KernelInstance
from .compiled import CompiledSystem, compile_system


@dataclass
class Component:
    """One connected component: constraint indices + its variable ids."""

    constraint_ids: List[int]
    var_ids: List[int]  # global ids, sorted
    local_of_global: Dict[int, int]


def connected_components(
    constraints: Sequence[Constraint], n_vars: int
) -> List[Component]:
    """Union-find over the variable-sharing graph.

    Delegates the find/union sweep to the native C++ extension
    (``native/fastdecomp.cpp``) when available — the host-side bottleneck
    for million-constraint systems — with an identical-result Python
    fallback."""
    deps: List[List[int]] = [c.dependent_variable_ids() for c in constraints]

    roots = _component_roots_native(deps, n_vars)
    if roots is None:
        roots = _component_roots_python(deps, n_vars)
    var_root, cons_root = roots

    groups: Dict[int, Component] = {}
    for cid, root in enumerate(cons_root):
        if root < 0:
            root = -1  # constraints with no variables group together
        comp = groups.get(root)
        if comp is None:
            comp = Component(constraint_ids=[], var_ids=[], local_of_global={})
            groups[root] = comp
        comp.constraint_ids.append(cid)

    # Attach variables (including any participating only via shared roots).
    root_vars: Dict[int, set] = defaultdict(set)
    for vid in range(n_vars):
        r = var_root[vid]
        if r >= 0:
            root_vars[r].add(vid)
    for root, comp in groups.items():
        comp.var_ids = sorted(root_vars.get(root, ()))
        comp.local_of_global = {g: i for i, g in enumerate(comp.var_ids)}

    # Deterministic order: by first constraint id.
    return sorted(groups.values(), key=lambda c: c.constraint_ids[0])


def _component_roots_python(deps, n_vars):
    """(var_root, cons_root) — Python union-find (fallback)."""
    parent = list(range(n_vars))

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    seen = [False] * n_vars
    for ids in deps:
        for vid in ids:
            seen[vid] = True
        for other in ids[1:]:
            ra, rb = find(ids[0]), find(other)
            if ra != rb:
                parent[rb] = ra
    var_root = [find(v) if seen[v] else -1 for v in range(n_vars)]
    cons_root = [find(ids[0]) if ids else -1 for ids in deps]
    return var_root, cons_root


def _component_roots_native(deps, n_vars):
    """(var_root, cons_root) via the C++ extension, or None."""
    from ..native import load_fastdecomp

    mod = load_fastdecomp()
    if mod is None:
        return None
    offsets = np.zeros(len(deps) + 1, dtype=np.int32)
    for i, ids in enumerate(deps):
        offsets[i + 1] = offsets[i] + len(ids)
    flat = np.fromiter(
        (v for ids in deps for v in ids), dtype=np.int32, count=int(offsets[-1])
    )
    vr_bytes, cr_bytes = mod.components(n_vars, offsets, flat)
    var_root = np.frombuffer(vr_bytes, dtype=np.int32)
    cons_root = np.frombuffer(cr_bytes, dtype=np.int32)
    return var_root.tolist(), cons_root.tolist()


def _component_signature(
    comp: Component, constraints: Sequence[Constraint], weights: Sequence[float]
) -> tuple:
    """Topology signature: lowered kernel sequences with local variable ids,
    weights included, parameters excluded (they batch)."""
    items = []
    for cid in comp.constraint_ids:
        for inst in constraints[cid].lower():
            local = tuple(comp.local_of_global[v] for v in inst.var_ids)
            items.append((inst.kernel, local, weights[cid]))
    return tuple(items)


@dataclass
class Bucket:
    """Components sharing one topology, solvable as a single batch."""

    system: CompiledSystem  # compiled with local ids for the template
    components: List[Component]
    pars: Tuple[np.ndarray, ...]  # per-block (B, n_k, np_k)
    var_index: np.ndarray  # (B, n_local) gather/scatter map to global x
    cid_index: np.ndarray  # (B, n_local_constraints) map to global cids


def build_buckets(
    constraints: Sequence[Constraint],
    n_vars: int,
    weights: Optional[Sequence[float]] = None,
    dtype=None,
) -> List[Bucket]:
    import jax.numpy as jnp

    if weights is None:
        weights = [1.0] * len(constraints)
    if dtype is None:
        dtype = jnp.float64
    comps = connected_components(constraints, n_vars)
    by_sig: Dict[tuple, List[Component]] = defaultdict(list)
    for comp in comps:
        by_sig[_component_signature(comp, constraints, weights)].append(comp)

    buckets: List[Bucket] = []
    for sig in sorted(by_sig.keys(), key=lambda s: str(s)):
        group = by_sig[sig]
        template = group[0]

        # Compile the template component with local variable ids. Remapping
        # happens on the *lowered* instances: only the ids a kernel actually
        # gathers (e.g. Vertical touches just the two x ids even though its
        # datum line also names y ids that may belong to other components).
        local_constraints = []
        local_weights = []
        for cid in template.constraint_ids:
            insts = tuple(
                KernelInstance(
                    inst.kernel,
                    tuple(template.local_of_global[v] for v in inst.var_ids),
                    inst.params,
                )
                for inst in constraints[cid].lower()
            )
            local_constraints.append(_Lowered(insts))
            local_weights.append(weights[cid])
        system = compile_system(
            local_constraints, n_vars=len(template.var_ids),
            weights=local_weights, dtype=dtype,
        )

        # Batched parameters: every component's lowered params, stacked in
        # the template's block order. Components share the signature so the
        # lowering order matches exactly.
        pars_per_comp = []
        for comp in group:
            by_kind: Dict[str, List[tuple]] = defaultdict(list)
            for cid in comp.constraint_ids:
                for inst in constraints[cid].lower():
                    by_kind[inst.kernel].append(inst.params)
            pars_per_comp.append(by_kind)
        pars = []
        for b in system.blocks:
            stacked = np.stack(
                [
                    np.asarray(pc[b.spec.name], dtype=np.float64).reshape(
                        len(pc[b.spec.name]), b.spec.nparams
                    )
                    for pc in pars_per_comp
                ]
            )
            pars.append(stacked)

        var_index = np.stack([np.asarray(c.var_ids, dtype=np.int32) for c in group])
        cid_index = np.stack(
            [np.asarray(c.constraint_ids, dtype=np.int32) for c in group]
        )
        buckets.append(
            Bucket(
                system=system,
                components=group,
                pars=tuple(pars),
                var_index=var_index,
                cid_index=cid_index,
            )
        )
    return buckets


class _Lowered:
    """Pre-lowered constraint: satisfies the ``.lower()`` protocol that
    ``compile_system`` consumes."""

    __slots__ = ("instances",)

    def __init__(self, instances):
        self.instances = instances

    def lower(self):
        return list(self.instances)


@dataclass
class BlockSolveResult:
    x: np.ndarray  # (n_vars,) final values
    iterations: int  # max over components (reference reports one number)
    converged: bool  # all components converged
    satisfied: np.ndarray  # (n_constraints,) bool
    degenerate: np.ndarray  # (n_constraints,) bool
    n_components: int
    n_buckets: int


class BlockSolver:
    """Reusable decomposed solver: buckets, batched parameters, and jitted
    per-bucket solvers are built once; ``solve(x0)`` just dispatches."""

    def __init__(
        self,
        constraints: Sequence[Constraint],
        n_vars: int,
        weights: Optional[Sequence[float]] = None,
        config: Config = Config(),
        precision: str = "f64",
    ):
        """``precision`` selects the fleet path per component bucket (see
        ``BatchSolver``): "mixed" for the f32 LM with f64 refinement; the
        default stays reference-exact f64."""
        import jax.numpy as jnp

        from ..batch import BatchSolver

        self.n_vars = n_vars
        self.n_constraints = len(constraints)
        self.config = config
        self.buckets = build_buckets(constraints, n_vars, weights)
        self.n_components = sum(len(b.components) for b in self.buckets)
        self._solvers = [
            BatchSolver(b.system, config, batch_params=True,
                        precision=precision)
            for b in self.buckets
        ]
        self._pars = [tuple(jnp.asarray(p) for p in b.pars) for b in self.buckets]

    def solve(self, x0: np.ndarray) -> BlockSolveResult:
        import jax.numpy as jnp

        x_out = np.array(x0, dtype=np.float64)
        iterations = 0
        converged = True
        satisfied = np.ones(self.n_constraints, dtype=bool)
        degenerate = np.zeros(self.n_constraints, dtype=bool)

        for bucket, solver, pars in zip(self.buckets, self._solvers, self._pars):
            x0_batch = jnp.asarray(x_out[bucket.var_index])
            res = solver.solve(x0_batch, pars)
            xb = np.asarray(res.x)
            flat_vars = bucket.var_index.reshape(-1)
            x_out[flat_vars] = xb.reshape(-1)
            satisfied[bucket.cid_index.reshape(-1)] = np.asarray(res.satisfied).reshape(-1)
            degenerate[bucket.cid_index.reshape(-1)] = np.asarray(res.degenerate).reshape(-1)
            iterations = max(iterations, int(np.max(np.asarray(res.iterations))))
            converged = converged and bool(np.all(np.asarray(res.converged)))

        return BlockSolveResult(
            x=x_out,
            iterations=iterations,
            converged=converged,
            satisfied=satisfied,
            degenerate=degenerate,
            n_components=self.n_components,
            n_buckets=len(self.buckets),
        )


def solve_blocks(
    constraints: Sequence[Constraint],
    x0: np.ndarray,
    weights: Optional[Sequence[float]] = None,
    config: Config = Config(),
) -> BlockSolveResult:
    """One-shot convenience wrapper around ``BlockSolver``."""
    return BlockSolver(constraints, len(x0), weights, config).solve(x0)


class BlockProgram:
    """Decomposed drop-in for the public API's (CompiledSystem, jitted
    solver) pair.

    The reference exploits component sparsity implicitly through its
    sparse-LLT Newton step (``newton.rs:15``, faer): a sketch of K
    independent blocks factors in sum(n_k^3), not (sum n_k)^3. The
    monolithic dense path cannot — ``massive[600]`` is a 2400-var dense
    Cholesky per LM iteration. The accelerator's shape of that sparsity is
    *batching*: group components by topology signature (``build_buckets``)
    and run ONE vmapped LM per bucket, every bucket fused into a single
    jitted program.

    The program returns the SAME packed outcome layout as
    ``solver.make_solver`` (``[x | sat | deg | converged | iterations]``,
    ONE device->host transfer; ``unpack_solver_result`` applies
    unchanged), so the API's cascade, the CLI, and the pipelined timing
    protocol work identically on both paths.

    Semantics vs the monolithic path: per-component LM gives each block
    its own damping schedule and convergence test — identical fixed
    points (the normal equations are block-diagonal) and identical
    trajectories for homogeneous fleets, but possibly different iteration
    counts on heterogeneous sketches; ``iterations`` reports the max over
    components (one number, like the reference). The API only takes this
    path past a component-count threshold (``api._DECOMPOSE_MIN``), so
    small interactive sketches keep the reference-exact global loop.
    ``jacobian_dense`` assembles the global weighted Jacobian for the
    freedom analysis (row order is per-bucket; the analysis is
    row-order-invariant — SVD of the same row set).
    """

    def __init__(
        self,
        constraints: Sequence[Constraint],
        n_vars: int,
        weights: Optional[Sequence[float]] = None,
        max_iterations: int = 50,
        precision: str = "f64",
    ):
        import jax
        import jax.numpy as jnp

        from ..solver import solve_lm, solve_lm_mixed

        self.n_vars = n_vars
        self.n_constraints = len(constraints)
        self.dtype = jnp.float64
        self.buckets = build_buckets(constraints, n_vars, weights)
        self.n_components = sum(len(b.components) for b in self.buckets)

        # Safety: every constraint must land in exactly one component
        # (a constraint with no variables never would). The API falls
        # back to the monolithic path when coverage is incomplete.
        covered = np.zeros(self.n_constraints, dtype=bool)
        for b in self.buckets:
            covered[b.cid_index.reshape(-1)] = True
        self.complete = bool(covered.all())

        self._row_dims = np.asarray(
            [c.residual_dim() for c in constraints], dtype=np.int64
        )
        self.n_rows = int(self._row_dims.sum())

        # Keep every traced constant as NUMPY (the compiled-system
        # convention): jnp closures would lower as device constants that
        # are fetched back to the host during MLIR lowering.
        gix = [b.var_index for b in self.buckets]
        cix = [b.cid_index for b in self.buckets]
        pars = [tuple(np.asarray(p) for p in b.pars) for b in self.buckets]
        systems = [b.system for b in self.buckets]
        mixed = precision == "mixed"
        systems32 = [s.astype(jnp.float32) for s in systems] if mixed else None
        pars32 = (
            [tuple(p.astype(np.float32) for p in pk) for pk in pars]
            if mixed else None
        )
        n_cons = self.n_constraints

        from ..ops.linalg import (UNROLL_COL_MAX_N, UNROLL_MAX_N,
                                  spd_solve_batched)
        from ..ops.linalg import spd_solve as _spd_plain

        def run(x0, rtol, stol, lam0):
            dt = x0.dtype
            x_out = x0
            sat = jnp.zeros((n_cons,), dt)
            deg = jnp.zeros((n_cons,), dt)
            conv = jnp.asarray(True)
            iters = jnp.asarray(0, jnp.int32)
            for k, (system, gi, ci, pk) in enumerate(
                    zip(systems, gix, cix, pars)):
                fast_sat = system.all_weights_positive()
                spd = (
                    spd_solve_batched
                    if UNROLL_MAX_N < system.n_vars <= UNROLL_COL_MAX_N
                    else _spd_plain
                )
                s32 = systems32[k] if mixed else None

                def one(xx, pp, pp32, system=system, s32=s32,
                        fast_sat=fast_sat, spd=spd):
                    if mixed:
                        res = solve_lm_mixed(
                            system, s32, xx, max_iterations, rtol, stol,
                            lam0, pars64=pp, pars32=pp32, spd=spd,
                        )
                    else:
                        res = solve_lm(system, xx, max_iterations, rtol,
                                       stol, lam0, pars=pp, spd=spd)
                    if fast_sat:
                        s = system.satisfaction_from_residual(res.residual)
                    else:
                        s = system.constraint_satisfaction(res.x, pp)
                    return res.x, s, res.deg, res.converged, res.iterations

                pk32 = pars32[k] if mixed else pk
                # Gather from x0, not x_out: buckets own disjoint variables,
                # and gathering from the running scatter would chain every
                # bucket's solve behind the previous one's update in the
                # jaxpr for no reason (XLA can overlap independent buckets).
                xb, sb, db, cb, ib = jax.vmap(one)(x0[gi], pk, pk32)
                x_out = x_out.at[gi.reshape(-1)].set(xb.reshape(-1))
                sat = sat.at[ci.reshape(-1)].set(sb.reshape(-1).astype(dt))
                deg = deg.at[ci.reshape(-1)].set(db.reshape(-1).astype(dt))
                conv = conv & jnp.all(cb)
                iters = jnp.maximum(iters, jnp.max(ib))
            return jnp.concatenate([
                x_out, sat, deg,
                jnp.stack([conv.astype(dt), iters.astype(dt)]),
            ])

        self._solver = jax.jit(run)

    def solver(self, x0, rtol, stol, lam0):
        """Same call signature and packed return as ``make_solver(...)``."""
        return self._solver(x0, rtol, stol, lam0)

    def jacobian_dense(self, x) -> np.ndarray:
        """Global weighted dense Jacobian at ``x`` for the freedom
        analysis, assembled from per-bucket batched Jacobians. Rows are
        grouped by bucket (not constraint id); ``freedom_analysis`` is
        row-order-invariant."""
        import jax
        import jax.numpy as jnp

        x = np.asarray(x, dtype=np.float64)
        out = np.zeros((self.n_rows, self.n_vars), dtype=np.float64)
        row = 0
        for b in self.buckets:
            system = b.system
            pars = tuple(jnp.asarray(p) for p in b.pars)
            jb = np.asarray(jax.vmap(system.jacobian_dense)(
                jnp.asarray(x[b.var_index]), pars
            ))  # (B, m_local, n_local)
            B, m_local, _ = jb.shape
            for k in range(B):
                out[row:row + m_local, b.var_index[k]] = jb[k]
                row += m_local
        return out

    def freedom_analysis(self, x):
        """Freedom (DoF) analysis via per-bucket batched SVDs — exact, not
        an approximation: the global Jacobian is block-diagonal up to a
        permutation, so its singular values are the union of the blocks'
        and the nullspace projector (whose diagonal IS the participation
        vector, basis-independent) is block-diagonal. Both reference
        thresholds stay GLOBAL like ``dof.freedom_analysis``: the rank cut
        1e-8 * largest singular value ACROSS blocks (find_dof.rs:40-47 —
        a per-block tolerance would misclassify blocks whose rows are
        globally negligible, e.g. weight-1e-12 requests), and the
        participation cut 1e-3 * max participation across all variables.
        A guessed-but-unconstrained variable is a zero column: e_i lies in
        the nullspace, participation exactly 1. Replaces an O(n^3) global
        SVD with sum over buckets of O(B * n_k^3)."""
        import jax
        import jax.numpy as jnp

        from ..dof import TOLERANCE_BASE, FreedomAnalysis
        from ..utils.errors import EmptySystemNotAllowed

        if self.n_rows == 0 or self.n_vars == 0:
            raise EmptySystemNotAllowed()

        x = np.asarray(x, dtype=np.float64)
        svals, vts = [], []
        for b in self.buckets:
            pars = tuple(jnp.asarray(p) for p in b.pars)
            jb = np.asarray(jax.vmap(b.system.jacobian_dense)(
                jnp.asarray(x[b.var_index]), pars
            ))  # (B, m_local, n_local)
            _u, s, vt = np.linalg.svd(jb, full_matrices=True)
            svals.append(s)
            vts.append(vt)

        largest = max((float(s.max()) for s in svals if s.size), default=0.0)
        tol = TOLERANCE_BASE * largest
        participation = np.ones(self.n_vars, dtype=np.float64)  # zero cols
        for b, s, vt in zip(self.buckets, svals, vts):
            rank = (s > tol).sum(axis=1)  # (B,)
            n_local = vt.shape[2]
            null_rows = np.arange(n_local)[None, :] >= rank[:, None]
            part = np.einsum("bji,bji->bi", vt * null_rows[:, :, None], vt)
            participation[b.var_index] = part

        max_participation = float(participation.max()) if self.n_vars else 0.0
        var_tol = 1e-3 * max_participation
        squared = var_tol * var_tol
        under = [int(i) for i in range(self.n_vars)
                 if participation[i] > squared]
        return FreedomAnalysis(under)
