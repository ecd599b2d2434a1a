"""Multi-objective categorical search engine (counterpart of the JAX
package's ``search/engine.py``, pure Python and copied here so that the
port imports nothing of that package).

The reference drives mixed-precision search with Optuna (Random / TPE /
NSGA-II / NSGA-III / QMC samplers, four maximized objectives,
``study.optimize(n_trials, n_jobs, timeout)``, ``study.best_trials`` as the
Pareto front). This engine implements the same contract without Optuna;
every search space is categorical (per-node width / block choices):

- RandomSampler: uniform per choice.
- TPESampler: categorical Tree-structured Parzen Estimator. Completed
  trials are split good/bad by non-domination rank (multi-objective) or
  value (single); choices are drawn proportional to the smoothed ratio
  l(c)/g(c).
- NSGAIISampler: genetic: binary tournament on (rank, crowding distance),
  uniform crossover, per-gene mutation.
- NSGAIIISampler: NSGA-II selection with reference-direction niching on
  the normalized objective simplex.
- QMCSampler: scrambled Halton sequence, one base prime per parameter.

The samplers draw from Python's ``random`` seeded by the study's seed, so a
seed and an objective give the JAX package's trials, in its order, with
its params and values. Trials, studies and the Pareto front are plain
picklable objects (``study.pkl``, the trial extractor).
"""

from __future__ import annotations

import ast
import logging
import math
import pickle
import random
import time
from dataclasses import dataclass, field


@dataclass
class FrozenTrial:
    number: int
    params: dict = field(default_factory=dict)
    distributions: dict = field(default_factory=dict)
    values: list | None = None
    state: str = "RUNNING"  # RUNNING | COMPLETE | FAIL

    @property
    def value(self):
        return self.values[0] if self.values else None


class Trial:
    def __init__(self, number: int, study: "Study"):
        self.number = number
        self.study = study
        self.params: dict = {}
        self.distributions: dict = {}

    def suggest_categorical(self, name: str, choices: list):
        if name in self.params:
            return self.params[name]
        value = self.study.sampler.suggest(self.study, self, name, list(choices))
        self.params[name] = value
        self.distributions[name] = list(choices)
        return value


def _dominates(a: list, b: list) -> bool:
    """a dominates b (all objectives maximize)."""
    return all(x >= y for x, y in zip(a, b)) and any(x > y for x, y in zip(a, b))


def non_dominated_sort(trials: list[FrozenTrial]) -> list[list[FrozenTrial]]:
    fronts: list[list[FrozenTrial]] = []
    remaining = [t for t in trials if t.values is not None]
    while remaining:
        front = [
            t
            for t in remaining
            if not any(
                _dominates(o.values, t.values) for o in remaining if o is not t
            )
        ]
        if not front:  # identical values edge case
            front = list(remaining)
        fronts.append(front)
        remaining = [t for t in remaining if t not in front]
    return fronts


def crowding_distance(front: list[FrozenTrial]) -> dict[int, float]:
    if not front:
        return {}
    n_obj = len(front[0].values)
    dist = {t.number: 0.0 for t in front}
    for m in range(n_obj):
        ordered = sorted(front, key=lambda t: t.values[m])
        lo, hi = ordered[0].values[m], ordered[-1].values[m]
        dist[ordered[0].number] = dist[ordered[-1].number] = float("inf")
        if hi == lo:
            continue
        for i in range(1, len(ordered) - 1):
            dist[ordered[i].number] += (
                ordered[i + 1].values[m] - ordered[i - 1].values[m]
            ) / (hi - lo)
    return dist


class BaseSampler:
    def __init__(self, seed: int | None = None):
        self.rng = random.Random(seed)

    def before_trial(self, study: "Study", trial: Trial):
        pass

    def suggest(self, study, trial, name, choices):
        raise NotImplementedError


class RandomSampler(BaseSampler):
    def suggest(self, study, trial, name, choices):
        return self.rng.choice(choices)


class TPESampler(BaseSampler):
    def __init__(self, seed=None, n_startup_trials: int = 10, gamma: float = 0.25):
        super().__init__(seed)
        self.n_startup_trials = n_startup_trials
        self.gamma = gamma

    def suggest(self, study, trial, name, choices):
        done = [t for t in study.trials if t.state == "COMPLETE"]
        if len(done) < self.n_startup_trials:
            return self.rng.choice(choices)
        # rank trials: non-domination rank, then crowding (multi-objective) or
        # plain value (single-objective)
        if len(study.directions) == 1:
            ranked = sorted(done, key=lambda t: -t.values[0])
        else:
            ranked = []
            for front in non_dominated_sort(done):
                cd = crowding_distance(front)
                ranked.extend(
                    sorted(front, key=lambda t: -cd.get(t.number, 0.0))
                )
        n_good = max(1, int(len(ranked) * self.gamma))
        good, bad = ranked[:n_good], ranked[n_good:]

        def counts(trials_):
            c = {choice: 1.0 for choice in map(_key, choices)}  # +1 smoothing
            for t in trials_:
                v = _key(t.params.get(name))
                if v in c:
                    c[v] += 1.0
            total = sum(c.values())
            return {k: v / total for k, v in c.items()}

        l, g = counts(good), counts(bad)
        weights = [l[_key(c)] / g[_key(c)] for c in choices]
        total = sum(weights)
        r = self.rng.random() * total
        acc = 0.0
        for c, w in zip(choices, weights):
            acc += w
            if r <= acc:
                return c
        return choices[-1]


def _key(v):
    """Hashable key for a choice value (lists arrive as '!ast!...' strings
    already, but be safe)."""
    if isinstance(v, list):
        return tuple(v)
    return v


class NSGAIISampler(BaseSampler):
    def __init__(self, seed=None, population_size: int = 20, mutation_prob=None):
        super().__init__(seed)
        self.population_size = population_size
        self.mutation_prob = mutation_prob
        self._parents: tuple[FrozenTrial, FrozenTrial] | None = None

    def _tournament(self, pop, rank, cd):
        a, b = self.rng.sample(pop, 2) if len(pop) >= 2 else (pop[0], pop[0])
        ka = (rank[a.number], -cd.get(a.number, 0.0))
        kb = (rank[b.number], -cd.get(b.number, 0.0))
        return a if ka <= kb else b

    def before_trial(self, study, trial):
        done = [t for t in study.trials if t.state == "COMPLETE"]
        if len(done) < self.population_size:
            self._parents = None
            return
        fronts = self._select_fronts(done)
        pop, rank, cd = [], {}, {}
        for i, front in enumerate(fronts):
            fcd = crowding_distance(front)
            for t in front:
                rank[t.number] = i
                cd[t.number] = fcd.get(t.number, 0.0)
            pop.extend(front)
            if len(pop) >= self.population_size:
                break
        self._parents = (
            self._tournament(pop, rank, cd),
            self._tournament(pop, rank, cd),
        )

    def _select_fronts(self, done):
        return non_dominated_sort(done[-2 * self.population_size :])

    def suggest(self, study, trial, name, choices):
        if self._parents is None:
            return self.rng.choice(choices)
        p1, p2 = self._parents
        n_params = max(1, len(p1.params))
        mut = self.mutation_prob if self.mutation_prob is not None else 1.0 / n_params
        if self.rng.random() < mut:
            return self.rng.choice(choices)
        donor = p1 if self.rng.random() < 0.5 else p2
        v = donor.params.get(name, None)
        if v is None or _key(v) not in [_key(c) for c in choices]:
            return self.rng.choice(choices)
        return v


class NSGAIIISampler(NSGAIISampler):
    """NSGA-II machinery + reference-direction niching for selection."""

    def _select_fronts(self, done):
        fronts = non_dominated_sort(done[-2 * self.population_size :])
        if not fronts or len(fronts[0]) < 2:
            return fronts
        # niche the first front onto Das-Dennis-style reference directions
        f0 = fronts[0]
        n_obj = len(f0[0].values)
        mins = [min(t.values[m] for t in f0) for m in range(n_obj)]
        maxs = [max(t.values[m] for t in f0) for m in range(n_obj)]

        def normalize(t):
            return [
                (t.values[m] - mins[m]) / (maxs[m] - mins[m] + 1e-12)
                for m in range(n_obj)
            ]

        n_refs = max(4, self.population_size // 2)
        refs = [
            [math.cos(2 * math.pi * i / n_refs * (m + 1)) ** 2 for m in range(n_obj)]
            for i in range(n_refs)
        ]
        refs = [[x / (sum(r) + 1e-12) for x in r] for r in refs]
        niched, seen_niches = [], set()
        for t in f0:
            v = normalize(t)
            niche = min(
                range(n_refs),
                key=lambda i: sum((v[m] - refs[i][m]) ** 2 for m in range(n_obj)),
            )
            if niche not in seen_niches:
                niched.append(t)
                seen_niches.add(niche)
        leftovers = [t for t in f0 if t not in niched]
        fronts[0] = niched + leftovers
        return fronts


_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61]


def _halton(index: int, base: int) -> float:
    f, r = 1.0, 0.0
    i = index
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


class QMCSampler(BaseSampler):
    """Scrambled Halton: one base prime per parameter name."""

    def __init__(self, seed=None):
        super().__init__(seed)
        self._dims: dict[str, int] = {}
        self._shifts: dict[str, float] = {}

    def suggest(self, study, trial, name, choices):
        if name not in self._dims:
            d = len(self._dims)
            self._dims[name] = _PRIMES[d % len(_PRIMES)]
            self._shifts[name] = self.rng.random()
        u = (_halton(trial.number + 1, self._dims[name]) + self._shifts[name]) % 1.0
        return choices[int(u * len(choices)) % len(choices)]


SAMPLER_MAP = {
    "random": RandomSampler,
    "tpe": TPESampler,
    "nsgaii": NSGAIISampler,
    "nsgaiii": NSGAIIISampler,
    "qmc": QMCSampler,
}


class Study:
    def __init__(self, directions: list[str], sampler: BaseSampler | None = None):
        assert all(d == "maximize" for d in directions), "only maximize supported"
        self.directions = directions
        self.sampler = sampler or RandomSampler()
        self.trials: list[FrozenTrial] = []

    def optimize(
        self,
        func,
        n_trials: int,
        n_jobs: int = 1,
        timeout: float | None = None,
        callbacks=(),
        show_progress_bar: bool = False,
    ):
        # objectives here are whole-model evals on one accelerator; parallel
        # trials would contend for it, so n_jobs is accepted but sequential
        if n_jobs not in (1, None):
            logging.getLogger(__name__).warning(
                f"n_jobs={n_jobs} requested but trials run sequentially: "
                "each objective is a whole-model eval on one accelerator, "
                "so parallel trials would contend for the device"
            )
        start = time.monotonic()
        for _ in range(n_trials):
            if timeout is not None and time.monotonic() - start > timeout:
                break
            number = len(self.trials)
            trial = Trial(number, self)
            self.sampler.before_trial(self, trial)
            frozen = FrozenTrial(number=number)
            self.trials.append(frozen)
            try:
                values = func(trial)
            except Exception:
                frozen.state = "FAIL"
                frozen.params = trial.params
                frozen.distributions = trial.distributions
                raise
            if not isinstance(values, (list, tuple)):
                values = (values,)
            assert len(values) == len(self.directions)
            frozen.params = trial.params
            frozen.distributions = trial.distributions
            frozen.values = list(map(float, values))
            frozen.state = "COMPLETE"
            for cb in callbacks:
                cb(self, frozen)

    @property
    def best_trials(self) -> list[FrozenTrial]:
        done = [t for t in self.trials if t.state == "COMPLETE"]
        if not done:
            return []
        fronts = non_dominated_sort(done)
        return fronts[0] if fronts else []

    @property
    def best_trial(self) -> FrozenTrial:
        assert len(self.directions) == 1
        return max(
            (t for t in self.trials if t.state == "COMPLETE"),
            key=lambda t: t.values[0],
        )

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path) -> "Study":
        with open(path, "rb") as f:
            return pickle.load(f)


def create_study(directions: list[str], sampler: BaseSampler | None = None) -> Study:
    return Study(directions, sampler)


def get_sampler(name: str, seed: int | None = None) -> BaseSampler:
    name = name.lower()
    assert name in SAMPLER_MAP, f"Unknown sampler: {name} ({list(SAMPLER_MAP)})"
    return SAMPLER_MAP[name](seed=seed)


def decode_ast_value(v):
    """'!ast!<literal>' -> literal (reference quant_config_sampler.py:13-14)."""
    if isinstance(v, str) and v.startswith("!ast!"):
        return ast.literal_eval(v.removeprefix("!ast!"))
    return v
