"""Sharding constraints, as far as one device needs them.

The reference's models call ``constrain(x, rules, logical_axes)`` at every
layer boundary; with ``rules=None`` it hands ``x`` back untouched
(``src/repro/dist/sharding.py:179-180``).  That is all the one-device
serving path needs.  Logical-axis rules mapped onto several ranks
(``ShardingRules``, ``dp_rules``, ``tp_rules``, ``derive_rules_from_plan``)
wait for ROADMAP Queue A item 10.
"""

from __future__ import annotations

from typing import Any, Sequence


def constrain(x, rules: Any, logical_axes: Sequence[str | None]):
    """``x`` itself when there are no rules; rules raise until the
    multi-rank layer is ported."""
    if rules is None:
        return x
    raise NotImplementedError(
        "sharding rules need several ranks: ROADMAP Queue A item 10 "
        f"(asked to constrain {tuple(logical_axes)})")
