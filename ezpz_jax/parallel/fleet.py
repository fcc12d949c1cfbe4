"""Fleet data-parallelism: shard a batch of independent sketches over devices.

The batch axis of ``BatchSolver`` is embarrassingly parallel — each sketch's
LM loop is independent — so the only communication is the initial scatter and
final gather. The fleet jits ``BatchSolver``'s OWN unjitted vmapped callable
with a ``NamedSharding`` over a 1-D mesh — XLA partitions everything along
the batch axis with zero collectives in the hot loop, and the multi-device
path is the single-device path by construction.

The reference has no equivalent (single-threaded CPU solve,
``ezpz/src/lib.rs:80-87``); this is the BASELINE.json multi-chip target.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..batch import BatchResult, BatchSolver
from ..config import Config
from ..models.compiled import CompiledSystem


class FleetSolver:
    """Solve B same-topology sketches sharded across a device mesh.

    B must be divisible by the mesh size (pad the fleet if needed).
    ``precision`` mirrors ``BatchSolver``.

    On the test/CI mesh (8 faked CPU devices) a fleet of 8 sketches puts
    one sketch on each device; results are bit-identical to the local
    ``BatchSolver``:

    >>> import jax, numpy as np
    >>> from ezpz_jax import Constraint, DatumPoint
    >>> from ezpz_jax.models.compiled import compile_system
    >>> from ezpz_jax.parallel import FleetSolver
    >>> p, q = DatumPoint(0, 1), DatumPoint(2, 3)
    >>> system = compile_system([Constraint.Fixed(0, 0.0),
    ...                          Constraint.Fixed(1, 0.0),
    ...                          Constraint.Distance(p, q, 4.0)], n_vars=4)
    >>> B = len(jax.devices())
    >>> x0 = np.tile([0.0, 0.0, 4.4, 4.4], (B, 1))
    >>> res = FleetSolver(system).solve(x0)
    >>> bool(np.asarray(res.converged).all())
    True
    """

    def __init__(
        self,
        system: CompiledSystem,
        mesh: Optional[Mesh] = None,
        config: Config = Config(),
        batch_params: bool = False,
        precision: str = "f64",
    ):
        if mesh is None:
            mesh = Mesh(np.array(jax.devices()), ("batch",))
        self.mesh = mesh
        self.system = system
        self.config = config
        self.batch_params = batch_params
        self.precision = precision

        # The local solver provides the unjitted vmapped callable; sharing
        # it keeps fleet and single-device semantics identical.
        self._local = BatchSolver(
            system, config, batch_params=batch_params, precision=precision,
        )

        batch_sharding = NamedSharding(mesh, P("batch"))
        scalar_sharding = NamedSharding(mesh, P())
        if batch_params:
            n_blocks = len(system.blocks)
            in_shardings = (
                batch_sharding,
                tuple(batch_sharding for _ in range(n_blocks)),
                scalar_sharding,
                scalar_sharding,
                scalar_sharding,
            )
        else:
            in_shardings = (batch_sharding,) + (scalar_sharding,) * 3
        self._run = jax.jit(self._local._vmapped, in_shardings=in_shardings)

    def solve(self, x0: jnp.ndarray, pars: Optional[Tuple] = None) -> BatchResult:
        c = self.config
        args = (x0,) + ((pars,) if self.batch_params else ())
        res, sat = self._run(
            *args, c.residual_tolerance, c.step_tolerance, c.initial_lambda
        )
        return BatchResult(
            x=res.x,
            iterations=res.iterations,
            converged=res.converged,
            satisfied=sat,
            degenerate=res.deg,
        )
