"""Multi-device execution: fleet data-parallelism and sharded single-system
solves over a ``jax.sharding.Mesh`` (XLA collectives over the cards'
interconnect — the reference is single-threaded CPU; SURVEY.md section 2
defines these equivalents)."""

from .block_schur import BlockSchurSolver
from .fleet import FleetSolver
from .hier import ShardedBlockSchurSolver
from .schur import ShardedSchurSolver

__all__ = [
    "BlockSchurSolver",
    "FleetSolver",
    "ShardedBlockSchurSolver",
    "ShardedSchurSolver",
]
