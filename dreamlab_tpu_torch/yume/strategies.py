"""Seed exploration strategies for dream sessions (a copy of
``dreamlab_tpu/yume/strategies.py``, which imports nothing of JAX).

Each strategy proposes seeds from the ``RandomState`` it is given:
evolutionary keeps a scored population with average-seed crossover and
+-10000 mutation; temperature annealing walks around the best seed; cluster
explores several regions.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

MAX_SEED = 2**31 - 1


class ExplorationStrategy(abc.ABC):
    def __init__(self, rng: Optional[np.random.RandomState] = None):
        self.rng = rng or np.random.RandomState()

    @abc.abstractmethod
    def next_seed(self) -> int:
        ...

    def record_score(self, seed: int, score: float):
        """Feedback hook; stateless strategies ignore it."""

    def _clip(self, seed) -> int:
        return int(abs(int(seed))) % MAX_SEED


class RandomStrategy(ExplorationStrategy):
    def next_seed(self) -> int:
        return int(self.rng.randint(0, MAX_SEED))


class LinearWalkStrategy(ExplorationStrategy):
    """Fixed-stride walk from a random origin."""

    def __init__(self, rng=None, stride: int = 1000):
        super().__init__(rng)
        self.current = int(self.rng.randint(0, MAX_SEED))
        self.stride = stride

    def next_seed(self) -> int:
        self.current = self._clip(self.current + self.stride)
        return self.current


class GridStrategy(ExplorationStrategy):
    """Evenly spaced seeds over the space, row by row."""

    def __init__(self, rng=None, rows: int = 100, cols: int = 100):
        super().__init__(rng)
        self.rows, self.cols = rows, cols
        self._i = 0

    def next_seed(self) -> int:
        r, c = divmod(self._i, self.cols)
        self._i += 1
        seed = (r % self.rows) * (MAX_SEED // self.rows) + c * (
            MAX_SEED // (self.rows * self.cols)
        )
        return self._clip(seed)


class EvolutionaryStrategy(ExplorationStrategy):
    """Score-ranked population; crossover = mean of two parents' seeds,
    mutation = +-10000 jitter."""

    def __init__(self, rng=None, population_size: int = 16,
                 mutation_range: int = 10000, elite_frac: float = 0.5):
        super().__init__(rng)
        self.population: List[Tuple[int, float]] = []
        self.population_size = population_size
        self.mutation_range = mutation_range
        self.elite_frac = elite_frac

    def next_seed(self) -> int:
        if len(self.population) < self.population_size:
            return int(self.rng.randint(0, MAX_SEED))
        elites = sorted(self.population, key=lambda p: -p[1])
        elites = elites[: max(2, int(len(elites) * self.elite_frac))]
        i, j = self.rng.choice(len(elites), 2, replace=False)
        child = (elites[i][0] + elites[j][0]) // 2  # crossover
        child += int(self.rng.randint(-self.mutation_range, self.mutation_range + 1))
        return self._clip(child)

    def record_score(self, seed: int, score: float):
        self.population.append((seed, score))
        if len(self.population) > 4 * self.population_size:
            self.population = sorted(self.population, key=lambda p: -p[1])[
                : self.population_size
            ]


class TemperatureScheduleStrategy(ExplorationStrategy):
    """Annealed walk around the best seed seen: jitter shrinks as the
    temperature decays."""

    def __init__(self, rng=None, initial_temp: float = 1.0,
                 decay: float = 0.995, min_temp: float = 0.05):
        super().__init__(rng)
        self.temp = initial_temp
        self.decay = decay
        self.min_temp = min_temp
        self.best: Tuple[Optional[int], float] = (None, -np.inf)

    def next_seed(self) -> int:
        self.temp = max(self.temp * self.decay, self.min_temp)
        if self.best[0] is None or self.rng.rand() < self.temp:
            return int(self.rng.randint(0, MAX_SEED))
        radius = int(self.temp * MAX_SEED * 0.01) + 1
        return self._clip(self.best[0] + self.rng.randint(-radius, radius + 1))

    def record_score(self, seed: int, score: float):
        if score > self.best[1]:
            self.best = (seed, score)


class ClusterStrategy(ExplorationStrategy):
    """Track K promising regions; sample around cluster centers."""

    def __init__(self, rng=None, num_clusters: int = 4, radius: int = 50_000,
                 explore_prob: float = 0.3):
        super().__init__(rng)
        self.num_clusters = num_clusters
        self.radius = radius
        self.explore_prob = explore_prob
        self.centers: List[Tuple[int, float]] = []

    def next_seed(self) -> int:
        if not self.centers or self.rng.rand() < self.explore_prob:
            return int(self.rng.randint(0, MAX_SEED))
        weights = np.array([max(s, 1e-6) for _, s in self.centers])
        idx = self.rng.choice(len(self.centers), p=weights / weights.sum())
        center = self.centers[idx][0]
        return self._clip(center + self.rng.randint(-self.radius, self.radius + 1))

    def record_score(self, seed: int, score: float):
        self.centers.append((seed, score))
        self.centers = sorted(self.centers, key=lambda c: -c[1])[: self.num_clusters]


_STRATEGIES = {
    "random": RandomStrategy,
    "linear": LinearWalkStrategy,
    "grid": GridStrategy,
    "evolutionary": EvolutionaryStrategy,
    "temperature": TemperatureScheduleStrategy,
    "cluster": ClusterStrategy,
}


def get_strategy(name: str, rng=None, **kwargs) -> ExplorationStrategy:
    if name not in _STRATEGIES:
        raise ValueError(
            f"unknown strategy {name!r}; choose from {sorted(_STRATEGIES)}"
        )
    return _STRATEGIES[name](rng=rng, **kwargs)
