"""Strategy registry: strategies are named objects selectable at runtime
(the reference picks one binary per strategy, ``test.sh:3,10``)."""

from __future__ import annotations

from .base import MatvecStrategy
from .blockwise import BlockwiseStrategy
from .colwise import (
    ColwiseAllToAllStrategy,
    ColwiseOverlapStrategy,
    ColwiseRingOverlapStrategy,
    ColwiseRingStrategy,
    ColwiseStrategy,
)
from .rowwise import RowwiseStrategy

STRATEGIES: dict[str, type[MatvecStrategy]] = {
    RowwiseStrategy.name: RowwiseStrategy,
    ColwiseStrategy.name: ColwiseStrategy,
    ColwiseRingStrategy.name: ColwiseRingStrategy,
    ColwiseRingOverlapStrategy.name: ColwiseRingOverlapStrategy,
    ColwiseAllToAllStrategy.name: ColwiseAllToAllStrategy,
    ColwiseOverlapStrategy.name: ColwiseOverlapStrategy,
    BlockwiseStrategy.name: BlockwiseStrategy,
}


def get_strategy(name: str, **kwargs) -> MatvecStrategy:
    try:
        cls = STRATEGIES[name]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; available: {sorted(STRATEGIES)}"
        ) from None
    return cls(**kwargs)


def available_strategies() -> list[str]:
    return sorted(STRATEGIES)


__all__ = [
    "MatvecStrategy",
    "RowwiseStrategy",
    "ColwiseStrategy",
    "ColwiseRingStrategy",
    "ColwiseRingOverlapStrategy",
    "ColwiseAllToAllStrategy",
    "ColwiseOverlapStrategy",
    "BlockwiseStrategy",
    "STRATEGIES",
    "get_strategy",
    "available_strategies",
]
