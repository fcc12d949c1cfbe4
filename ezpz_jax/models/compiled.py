"""Compile a constraint system to padded per-type arrays.

This is the batched replacement for the reference's sparse-triplet model
assembly (``ezpz/src/solver.rs:192-301``): instead of building a CSC sparsity
pattern and filling it row by row with a per-column linear search
(``solver.rs:412-418``), we group constraints by kernel type into static
``(n_type, nvars)`` index arrays and ``(n_type, nparams)`` parameter arrays.

Evaluation is then gather -> vmapped kernel -> concat (residual) and
gather -> vmapped ``jacfwd`` -> segment-sum outer products (normal
equations). Everything is static-shaped, jit-friendly, and batchable with
``vmap`` over many systems sharing a topology.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constraints import Constraint, ConstraintRequest
from ..ops.kernels import KERNELS, KernelSpec

# f32 contractions on the mixed paths must not drop to TF32 or bf16
# multiplies, which would keep the f64-verified residual from 1e-8.
_HIGHEST = jax.lax.Precision.HIGHEST

EPSILON = 1e-4  # satisfaction tolerance, ezpz/src/lib.rs:43


@dataclass(frozen=True)
class KindBlock:
    """All instances of one kernel type.

    Arrays are host numpy: they are topology constants baked into the jitted
    computation (lowering numpy constants avoids fetching device constants
    back to the host during lowering).
    """

    spec: KernelSpec
    idx: np.ndarray  # (n, nvars) int32 — gather indices into x
    par: np.ndarray  # (n, nparams) float
    weight: np.ndarray  # (n,) float — constraint weights
    cid: np.ndarray  # (n,) int32 — originating constraint index


@dataclass(frozen=True)
class CompiledSystem:
    """A constraint system compiled to arrays.

    ``n_vars`` is the length of the flat variable vector (indexed by Id).
    Residual rows are laid out grouped by kernel type; row order does not
    affect the LM iteration (JtJ, Jtr, and norms are order-invariant), and
    per-constraint bookkeeping goes through ``cid``.
    """

    n_vars: int
    n_constraints: int
    n_rows: int
    blocks: Tuple[KindBlock, ...]
    dtype: jnp.dtype = jnp.float64

    # -- evaluation ----------------------------------------------------------
    #
    # Every method takes an optional ``pars`` override: a tuple of (n, np)
    # arrays aligned with ``self.blocks``. With ``pars=None`` the compile-time
    # parameters are baked in as constants; passing ``pars`` makes parameters
    # dynamic inputs so one compiled solver serves a whole fleet of sketches
    # sharing a topology (the scenario-batching path).

    def _pars(self, pars, i):
        return self.blocks[i].par if pars is None else pars[i]

    def residual(self, x: jnp.ndarray, pars=None) -> jnp.ndarray:
        """Weighted global residual, shape (n_rows,). Matches the reference's
        ``Model::residual`` (``solver.rs:318-356``) up to row ordering."""
        parts = []
        for i, b in enumerate(self.blocks):
            res, _deg = jax.vmap(b.spec.fn)(x[b.idx], self._pars(pars, i))
            parts.append((res * b.weight[:, None]).reshape(-1))
        return jnp.concatenate(parts) if parts else jnp.zeros((0,), self.dtype)

    def residual_and_flags(self, x: jnp.ndarray, pars=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(weighted residual (n_rows,), per-constraint degenerate flags
        (n_constraints,) bool)."""
        parts = []
        deg_acc = jnp.zeros((self.n_constraints,), jnp.bool_)
        for i, b in enumerate(self.blocks):
            res, deg = jax.vmap(b.spec.fn)(x[b.idx], self._pars(pars, i))
            parts.append((res * b.weight[:, None]).reshape(-1))
            if b.spec.can_degenerate:  # constant-False flags skip the scatter
                deg_acc = deg_acc.at[b.cid].max(deg)
        r = jnp.concatenate(parts) if parts else jnp.zeros((0,), self.dtype)
        return r, deg_acc

    def normal_equations(
        self, x: jnp.ndarray, pars=None, rhs: Optional[jnp.ndarray] = None
    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """Evaluate r(x), JtJ, Jtr, and per-constraint degenerate flags.

        JtJ and Jtr are assembled scatter-add style from per-instance outer
        products — the segment-sum equivalent of the reference's sparse
        J^T * J product (``newton.rs:73-84``) without any sparse bookkeeping.

        ``rhs`` optionally substitutes an already-evaluated weighted residual
        (possibly in a wider dtype — it is cast to this system's dtype) for
        the right-hand side: ``jtr = J^T cast(rhs)``. This is the
        mixed-precision iterative-refinement path (see
        ``refine_normal_equations``); ``x`` is likewise cast, so the call is
        valid on an f32 twin with f64 inputs.
        """
        x = x.astype(self.dtype)
        n = self.n_vars
        jtj = jnp.zeros((n, n), self.dtype)
        jtr = jnp.zeros((n,), self.dtype)
        parts = []
        deg_acc = jnp.zeros((self.n_constraints,), jnp.bool_)
        slices = self.block_row_slices() if rhs is not None else None
        for i, b in enumerate(self.blocks):
            v = x[b.idx]  # (nb, nv)
            jac, (res, deg) = jax.vmap(
                lambda vv, pp, fn=b.spec.fn: _jac_with_value(fn, vv, pp)
            )(v, self._pars(pars, i))
            if rhs is None:
                wres = res * b.weight[:, None]  # (nb, dim)
            else:
                lo, hi = slices[i]
                wres = rhs[lo:hi].astype(self.dtype).reshape(
                    jac.shape[0], b.spec.dim
                )
            wjac = jac * b.weight[:, None, None]  # (nb, dim, nv)
            contrib = jnp.einsum("ndk,ndl->nkl", wjac, wjac, precision=_HIGHEST)
            jtj = jtj.at[b.idx[:, :, None], b.idx[:, None, :]].add(contrib)
            jtr = jtr.at[b.idx].add(
                jnp.einsum("ndk,nd->nk", wjac, wres, precision=_HIGHEST))
            parts.append(wres.reshape(-1))
            if b.spec.can_degenerate:  # constant-False flags skip the scatter
                deg_acc = deg_acc.at[b.cid].max(deg)
        r = jnp.concatenate(parts) if parts else jnp.zeros((0,), self.dtype)
        return r, jtj, jtr, deg_acc

    def jacobian_dense(self, x: jnp.ndarray, pars=None) -> jnp.ndarray:
        """Weighted dense Jacobian, shape (n_rows, n_vars). Used by the
        freedom (DoF) analysis; row order is the compiled row order."""
        J = jnp.zeros((self.n_rows, self.n_vars), self.dtype)
        row = 0
        for i, b in enumerate(self.blocks):
            nb = int(b.idx.shape[0])
            dim = b.spec.dim
            jac, (_res, _deg) = jax.vmap(
                lambda vv, pp, fn=b.spec.fn: _jac_with_value(fn, vv, pp)
            )(x[b.idx], self._pars(pars, i))
            wjac = jac * b.weight[:, None, None]  # (nb, dim, nv)
            rows = row + (
                jnp.arange(nb, dtype=jnp.int32)[:, None] * dim
                + jnp.arange(dim, dtype=jnp.int32)[None, :]
            )  # (nb, dim)
            J = J.at[rows[:, :, None], b.idx[:, None, :]].add(wjac)
            row += nb * dim
        return J

    def constraint_satisfaction(self, x: jnp.ndarray, pars=None) -> jnp.ndarray:
        """Per-constraint satisfaction: max |unweighted residual row| < 1e-4
        (``ezpz/src/lib.rs:307-327,358-370``). Returns (n_constraints,) bool."""
        worst = jnp.zeros((self.n_constraints,), self.dtype)
        for i, b in enumerate(self.blocks):
            res, _deg = jax.vmap(b.spec.fn)(x[b.idx], self._pars(pars, i))
            inst_max = jnp.max(jnp.abs(res), axis=1)  # unweighted
            worst = worst.at[b.cid].max(inst_max)
        return worst < EPSILON

    def satisfaction_from_residual(self, r: jnp.ndarray) -> jnp.ndarray:
        """Per-constraint satisfaction derived from an already-evaluated
        weighted residual vector (no extra kernel evaluations): the
        unweighted row is ``|r| / w``, valid whenever every weight > 0
        (check ``all_weights_positive()`` before using this path). Saves a
        full residual pass per solve on the hot fleet path."""
        rows_cid = np.concatenate(
            [np.repeat(b.cid, b.spec.dim) for b in self.blocks]
        ) if self.blocks else np.zeros((0,), np.int32)
        rows_w = np.concatenate(
            [np.repeat(np.asarray(b.weight, np.float64), b.spec.dim) for b in self.blocks]
        ) if self.blocks else np.zeros((0,))
        worst = jnp.zeros((self.n_constraints,), r.dtype)
        worst = worst.at[rows_cid].max(jnp.abs(r) / jnp.asarray(rows_w, r.dtype))
        return worst < EPSILON

    def all_weights_positive(self) -> bool:
        return all(float(np.min(b.weight)) > 0.0 for b in self.blocks) if self.blocks else True

    def param_arrays(self) -> Tuple[np.ndarray, ...]:
        """The compile-time parameter arrays, aligned with ``blocks`` — the
        template for building batched ``pars`` overrides."""
        return tuple(b.par for b in self.blocks)

    def astype(self, dtype) -> "CompiledSystem":
        """The same topology with parameters/weights in another dtype (the
        f32 twin used by the mixed-precision solver)."""
        if dtype == self.dtype:
            return self
        from dataclasses import replace

        blocks = tuple(
            replace(b, par=b.par.astype(dtype), weight=b.weight.astype(dtype))
            for b in self.blocks
        )
        return CompiledSystem(
            n_vars=self.n_vars,
            n_constraints=self.n_constraints,
            n_rows=self.n_rows,
            blocks=blocks,
            dtype=dtype,
        )

    def block_row_slices(self) -> Tuple[Tuple[int, int], ...]:
        """(start, stop) row ranges of each block inside the concatenated
        residual vector (compiled row order)."""
        out = []
        row = 0
        for b in self.blocks:
            n = int(b.idx.shape[0]) * b.spec.dim
            out.append((row, row + n))
            row += n
        return tuple(out)

    def refine_normal_equations(self, x64: jnp.ndarray, r64: jnp.ndarray,
                                pars=None):
        """Mixed-precision normal equations for iterative refinement.

        The Jacobian is evaluated in THIS system's dtype (call on the f32
        twin) at ``x64.astype(dtype)``, while ``r64`` — the residual already
        evaluated in f64 at ``x64`` — supplies the right-hand side:
        ``jtr = J32^T cast(r64)``. Near a solution the step is
        |d| ~ |r| ~ 1e-6, so f32 *relative* accuracy on J and on the cast
        r64 gives ~1e-13 *absolute* step error — far below the 1e-8 target.
        Only the residual evaluation itself needs f64 (an absolutely
        accurate r); that happens outside, once per iteration.

        Returns (jtj, jtr, deg) in this system's dtype.
        """
        _r, jtj, jtr, deg_acc = self.normal_equations(x64, pars, rhs=r64)
        return jtj, jtr, deg_acc

    def jacobian_factors(self, x: jnp.ndarray, pars=None):
        """Per-block weighted Jacobians + residual, for matrix-free JtJ
        matvecs (large systems where a dense (n, n) JtJ won't fit).

        Returns (r, jtr, wjacs, deg) where ``wjacs`` is a list of (nb, dim,
        nv) arrays aligned with ``self.blocks``.
        """
        jtr = jnp.zeros((self.n_vars,), self.dtype)
        parts = []
        wjacs = []
        deg_acc = jnp.zeros((self.n_constraints,), jnp.bool_)
        for i, b in enumerate(self.blocks):
            jac, (res, deg) = jax.vmap(
                lambda vv, pp, fn=b.spec.fn: _jac_with_value(fn, vv, pp)
            )(x[b.idx], self._pars(pars, i))
            wres = res * b.weight[:, None]
            wjac = jac * b.weight[:, None, None]
            wjacs.append(wjac)
            jtr = jtr.at[b.idx].add(
                jnp.einsum("ndk,nd->nk", wjac, wres, precision=_HIGHEST))
            parts.append(wres.reshape(-1))
            if b.spec.can_degenerate:  # constant-False flags skip the scatter
                deg_acc = deg_acc.at[b.cid].max(deg)
        r = jnp.concatenate(parts) if parts else jnp.zeros((0,), self.dtype)
        return r, jtr, wjacs, deg_acc

    def jtj_matvec(self, wjacs, v: jnp.ndarray) -> jnp.ndarray:
        """(JtJ) v without materializing JtJ: per block, gather -> row
        contraction -> scatter-add. O(nnz) like the sparse product the
        reference forms explicitly (``newton.rs:73-77``)."""
        out = jnp.zeros((self.n_vars,), self.dtype)
        for b, wjac in zip(self.blocks, wjacs):
            vg = v[b.idx]  # (nb, nv)
            t = jnp.einsum("ndk,nk->nd", wjac, vg, precision=_HIGHEST)  # J v rows
            out = out.at[b.idx].add(
                jnp.einsum("ndk,nd->nk", wjac, t, precision=_HIGHEST))
        return out


def _jac_with_value(fn, v, p):
    """(d res / d v, (res, deg)) for a single instance."""

    def wrapped(vv):
        res, deg = fn(vv, p)
        return res, (res, deg)

    jac, (res, deg) = jax.jacfwd(wrapped, has_aux=True)(v)
    return jac, (res, deg)


def compile_system(
    constraints: Sequence[Constraint],
    n_vars: int,
    weights: Optional[Sequence[float]] = None,
    dtype=jnp.float64,
) -> CompiledSystem:
    """Group lowered kernel instances by type into padded arrays.

    ``constraints`` must already have tangency sides resolved
    (``Constraint.set_from_initial_values``).
    """
    if weights is None:
        weights = [1.0] * len(constraints)
    by_kind: dict = {}
    n_rows = 0
    for cid, (c, w) in enumerate(zip(constraints, weights)):
        for inst in c.lower():
            spec = KERNELS[inst.kernel]
            slot = by_kind.setdefault(inst.kernel, {"idx": [], "par": [], "w": [], "cid": []})
            assert len(inst.var_ids) == spec.nvars, (inst.kernel, inst.var_ids)
            assert len(inst.params) == spec.nparams, (inst.kernel, inst.params)
            slot["idx"].append(inst.var_ids)
            slot["par"].append(inst.params)
            slot["w"].append(w)
            slot["cid"].append(cid)
            n_rows += spec.dim

    blocks = []
    for kernel_name in sorted(by_kind.keys()):
        slot = by_kind[kernel_name]
        spec = KERNELS[kernel_name]
        nb = len(slot["idx"])
        blocks.append(
            KindBlock(
                spec=spec,
                idx=np.asarray(slot["idx"], dtype=np.int32).reshape(nb, spec.nvars),
                par=np.asarray(slot["par"], dtype=np.float64).reshape(nb, spec.nparams)
                .astype(dtype),
                weight=np.asarray(slot["w"], dtype=np.float64).astype(dtype),
                cid=np.asarray(slot["cid"], dtype=np.int32),
            )
        )

    return CompiledSystem(
        n_vars=n_vars,
        n_constraints=len(constraints),
        n_rows=n_rows,
        blocks=tuple(blocks),
        dtype=dtype,
    )


def topology_key(constraints: Sequence[Constraint], n_vars: int) -> tuple:
    """A hashable key identifying the compiled topology (for jit caching).

    The per-constraint fragment is memoized on the (immutable) constraint:
    this runs on EVERY public solve for the cache lookup, and profiled as
    the dominant host cost on many-constraint sketches."""
    items = []
    for c in constraints:
        frag = c.__dict__.get("_topo_frag")
        if frag is None:
            frag = tuple(
                (inst.kernel, inst.var_ids, inst.params) for inst in c.lower()
            )
            object.__setattr__(c, "_topo_frag", frag)
        items.append(frag)
    return (n_vars, tuple(items))
