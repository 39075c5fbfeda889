"""The least bytes a density-control round must move, and the alpha reset
after it, from the pool's size and the round's counts.

Whatever implements it, a round reads each pool array its masks read
once: the features (224 bytes a slot: the alpha logit and the NaN test of
the whole row), the invalid flag (1), the trigger step's in-frustum flag
(1), pixel count (4), gradient magnitude (4) and depth (4), and the six
accumulators (4 + 4 + 4 + 4 + 12 + 4); it writes the invalid flag (1) and
the six accumulators, zeroed (32). A filled slot's row (position 12,
features 224, object id 4) is read from its source and written to it; a
split source's position is read and its position and log-scales written
(12 + 24). The alpha reset writes each slot's alpha logit (4), read with
the features. Operations are a few a slot, far below the bytes' time.
"""

from __future__ import annotations

from .peaks import bound_ms

READ_PER_SLOT = 224 + 1 + 1 + 4 + 4 + 4 + 32
WRITE_PER_SLOT = 1 + 32
ROW = 12 + 224 + 4
SPLIT_SOURCE = 12 + 12 + 12
RESET_PER_SLOT = 4


def round_bytes(slots: int, filled: int, splits: int,
                resets: int = 0) -> int:
    """Bytes of one round over `slots` slots that filled `filled` slots,
    `splits` of them splits, with `resets` alpha resets after it."""
    return (slots * (READ_PER_SLOT + WRITE_PER_SLOT)
            + filled * 2 * ROW + splits * SPLIT_SOURCE
            + resets * slots * RESET_PER_SLOT)


def round_bound_ms(slots: int, filled: int, splits: int,
                   resets: int = 0) -> float:
    """The least time of such a round on the chip, in ms (bytes at the
    peak bandwidth)."""
    return bound_ms(0, round_bytes(slots, filled, splits, resets))[0]
