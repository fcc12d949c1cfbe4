"""Variable identifiers.

Mirrors the reference's ``Id = u32`` and incrementing ``IdGenerator``
(``ezpz/src/id.rs:3-30``): every scalar unknown (a point coordinate, a
radius, a free distance) is one integer id, which is also its column in the
Jacobian / its index in the flat variable vector.
"""

Id = int


class IdGenerator:
    """Generates an incrementing sequence of ids starting from 0
    (``id.rs:19-30``).

    >>> ids = IdGenerator()
    >>> ids.next_id(), ids.next_id(), ids.next_id()
    (0, 1, 2)

    Datum constructors consume ids in declaration order:

    >>> from ezpz_jax.datatypes import DatumPoint
    >>> ids = IdGenerator()
    >>> p = DatumPoint.new(ids)
    >>> p.id_x(), p.id_y()
    (0, 1)
    """

    def __init__(self) -> None:
        self._next: Id = 0

    def next_id(self) -> Id:
        out = self._next
        self._next += 1
        return out
