"""Fully-unrolled system evaluation for small topologies.

``CompiledSystem`` evaluates with constant-index gathers (``x[idx]``) and
scatter-adds — fine for XLA, but for tiny systems the gather/scatter
machinery costs more than the math. ``UnrolledSystem`` evaluates the SAME compiled
blocks with *static Python indexing*: every variable pick is ``x[int(j)]``,
every JtJ contribution lands with ``at[i, j]`` on literal ints, weights fold
in as Python floats. The traced program contains no constant arrays at all,
which makes it cheap for XLA to fuse.

Exposes the subset of the ``CompiledSystem`` interface the LM loop uses
(``dtype``, ``n_vars``, ``n_constraints``, ``residual_and_flags``,
``normal_equations``), so ``solver.solve_lm`` runs on it unchanged. Use for
topologies with up to a few dozen rows (trace size grows linearly with
instance count); the gather/scatter path remains the default elsewhere.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..models.compiled import CompiledSystem, _jac_with_value


class UnrolledSystem:
    def __init__(self, system: CompiledSystem):
        self.system = system
        self.dtype = system.dtype
        self.n_vars = system.n_vars
        self.n_constraints = system.n_constraints
        self.n_rows = system.n_rows

    def _instances(self, pars):
        """Yield (fn, var_ids, params, weight, cid, can_degenerate) with
        params traced per-instance when ``pars`` is given."""
        for bi, b in enumerate(self.system.blocks):
            block_pars = None if pars is None else pars[bi]
            for i in range(b.idx.shape[0]):
                if block_pars is None:
                    p = jnp.asarray(b.par[i], self.dtype)
                else:
                    p = block_pars[i]
                yield (
                    b.spec.fn,
                    [int(j) for j in b.idx[i]],
                    p,
                    float(b.weight[i]),
                    int(b.cid[i]),
                    b.spec.can_degenerate,
                )

    def residual_and_flags(self, x: jnp.ndarray, pars=None):
        rows = []
        deg = [jnp.asarray(False)] * self.n_constraints
        for fn, ids, p, w, cid, can_deg in self._instances(pars):
            v = jnp.stack([x[j] for j in ids])
            res, dg = fn(v, p)
            rows.append(res * w)
            if can_deg:
                deg[cid] = deg[cid] | dg
        r = (jnp.concatenate(rows) if rows
             else jnp.zeros((0,), self.dtype))
        return r, jnp.stack(deg) if deg else jnp.zeros((0,), jnp.bool_)

    @staticmethod
    def _accumulate(jtj_acc, jtr_acc, ids, wjac, wres):
        """Add one instance's JtJ/Jtr contributions in place.

        ``wjac``: (dim, nv) weighted Jacobian; ``wres``: indexable of dim
        weighted-residual scalars. Contractions unroll over the tiny
        residual dim — pure adds/muls (no dot_general).
        """
        dim = wjac.shape[0]
        for a, ga in enumerate(ids):
            acc = wjac[0, a] * wres[0]
            for d in range(1, dim):
                acc = acc + wjac[d, a] * wres[d]
            jtr_acc[ga] = jtr_acc[ga] + acc
            for b_, gb in enumerate(ids):
                acc2 = wjac[0, a] * wjac[0, b_]
                for d in range(1, dim):
                    acc2 = acc2 + wjac[d, a] * wjac[d, b_]
                jtj_acc[ga][gb] = jtj_acc[ga][gb] + acc2

    def normal_equations(self, x: jnp.ndarray, pars=None):
        n = self.n_vars
        zero = jnp.zeros((), self.dtype)
        # Accumulate JtJ/Jtr as Python lists of traced scalars and stack
        # ONCE at the end: no gathers, no scatter-adds.
        jtj_acc = [[zero for _ in range(n)] for _ in range(n)]
        jtr_acc = [zero for _ in range(n)]
        rows = []
        deg = [jnp.asarray(False)] * self.n_constraints
        for fn, ids, p, w, cid, can_deg in self._instances(pars):
            v = jnp.stack([x[j] for j in ids])
            jac, (res, dg) = _jac_with_value(fn, v, p)
            wjac = jac * w  # (dim, nv)
            wres = res * w  # (dim,)
            self._accumulate(jtj_acc, jtr_acc, ids, wjac, wres)
            rows.append(wres)
            if can_deg:
                deg[cid] = deg[cid] | dg
        jtj = jnp.stack([jnp.stack(row) for row in jtj_acc])
        jtr = jnp.stack(jtr_acc)
        r = (jnp.concatenate(rows) if rows
             else jnp.zeros((0,), self.dtype))
        return r, jtj, jtr, jnp.stack(deg) if deg else jnp.zeros((0,), jnp.bool_)

    def refine_normal_equations(self, x64: jnp.ndarray, r64: jnp.ndarray,
                                pars=None):
        """Static-index version of ``CompiledSystem.refine_normal_equations``
        (mixed-precision refinement: Jacobian in THIS system's dtype at
        ``x64.astype(dtype)``, right-hand side from the f64 residual
        ``r64``). Row offsets into ``r64`` follow instance order, which
        matches the compiled residual layout exactly."""
        x = x64.astype(self.dtype)
        n = self.n_vars
        zero = jnp.zeros((), self.dtype)
        jtj_acc = [[zero for _ in range(n)] for _ in range(n)]
        jtr_acc = [zero for _ in range(n)]
        deg = [jnp.asarray(False)] * self.n_constraints
        row = 0
        for fn, ids, p, w, cid, can_deg in self._instances(pars):
            jac, (_res, dg) = _jac_with_value(fn, jnp.stack([x[j] for j in ids]), p)
            wjac = jac * w  # (dim, nv)
            dim = wjac.shape[0]
            wres = [r64[row + d].astype(self.dtype) for d in range(dim)]
            row += dim
            self._accumulate(jtj_acc, jtr_acc, ids, wjac, wres)
            if can_deg:
                deg[cid] = deg[cid] | dg
        jtj = jnp.stack([jnp.stack(r_) for r_ in jtj_acc])
        jtr = jnp.stack(jtr_acc)
        return jtj, jtr, jnp.stack(deg) if deg else jnp.zeros((0,), jnp.bool_)

    def jacobian_dense(self, x: jnp.ndarray, pars=None):
        J = jnp.zeros((self.n_rows, self.n_vars), self.dtype)
        row = 0
        for fn, ids, p, w, cid, _can_deg in self._instances(pars):
            v = jnp.stack([x[j] for j in ids])
            jac, (_res, _dg) = _jac_with_value(fn, v, p)
            wjac = jac * w
            for d in range(wjac.shape[0]):
                for a, ga in enumerate(ids):
                    J = J.at[row + d, ga].add(wjac[d, a])
            row += wjac.shape[0]
        return J
