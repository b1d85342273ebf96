"""Copy of evostencils_tpu/optimization/nsga.py, kept in the port so that it imports
nothing of the JAX package.

Multi-objective selection: NSGA-II / NSGA-III, tournaments, hall of fame.

Native replacements for the DEAP tools the reference registers
(optimization/program.py:646-768): selNSGA2, selTournamentDCD, selNSGA3
with uniform reference points, selTournament, HallOfFame/ParetoFront with
string-dedup, and Logbook-style statistics.
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import List, Sequence

import numpy as np


def sort_nondominated(individuals, k=None, first_front_only=False):
    """Fast non-dominated sort (Deb et al. 2002)."""
    if k is None:
        k = len(individuals)
    fronts = [[]]
    dominated = defaultdict(list)
    domination_count = {}
    for i, p in enumerate(individuals):
        domination_count[i] = 0
    for i, p in enumerate(individuals):
        for j, q in enumerate(individuals):
            if i == j:
                continue
            if p.fitness.dominates(q.fitness):
                dominated[i].append(j)
            elif q.fitness.dominates(p.fitness):
                domination_count[i] += 1
        if domination_count[i] == 0:
            fronts[0].append(i)
    if first_front_only:
        return [[individuals[i] for i in fronts[0]]]
    total = len(fronts[0])
    while fronts[-1] and total < k:
        next_front = []
        for i in fronts[-1]:
            for j in dominated[i]:
                domination_count[j] -= 1
                if domination_count[j] == 0:
                    next_front.append(j)
        if not next_front:
            break
        fronts.append(next_front)
        total += len(next_front)
    return [[individuals[i] for i in front] for front in fronts if front]


def assign_crowding_distance(front):
    if not front:
        return
    n_obj = len(front[0].fitness.values)
    for ind in front:
        ind.crowding_distance = 0.0
    for m in range(n_obj):
        front.sort(key=lambda ind: ind.fitness.values[m])
        front[0].crowding_distance = math.inf
        front[-1].crowding_distance = math.inf
        fmin = front[0].fitness.values[m]
        fmax = front[-1].fitness.values[m]
        if fmax == fmin:
            continue
        for i in range(1, len(front) - 1):
            ind = front[i]
            if math.isinf(ind.crowding_distance):
                continue
            ind.crowding_distance += (
                front[i + 1].fitness.values[m] - front[i - 1].fitness.values[m]
            ) / (fmax - fmin)


def selNSGA2(individuals, k):
    fronts = sort_nondominated(individuals, k)
    chosen = []
    for front in fronts:
        assign_crowding_distance(front)
        if len(chosen) + len(front) <= k:
            chosen.extend(front)
        else:
            front.sort(key=lambda ind: ind.crowding_distance, reverse=True)
            chosen.extend(front[:k - len(chosen)])
            break
    return chosen


def selTournamentDCD(individuals, k, rng: random.Random = random):
    """Binary tournament on (dominance, crowding distance); k must be a
    multiple of 4 in DEAP — callers round up the same way."""

    def tourn(a, b):
        if a.fitness.dominates(b.fitness):
            return a
        if b.fitness.dominates(a.fitness):
            return b
        if a.crowding_distance > b.crowding_distance:
            return a
        if b.crowding_distance < a.crowding_distance:
            return b
        return a if rng.random() < 0.5 else b

    chosen = []
    while len(chosen) < k:
        sample = rng.sample(range(len(individuals)), min(4, len(individuals)))
        inds = [individuals[i] for i in sample]
        while len(inds) < 4:
            inds.append(rng.choice(individuals))
        chosen.append(tourn(inds[0], inds[1]))
        if len(chosen) < k:
            chosen.append(tourn(inds[2], inds[3]))
    return chosen[:k]


def selTournament(individuals, k, tournsize=2, rng: random.Random = random):
    chosen = []
    for _ in range(k):
        aspirants = [rng.choice(individuals) for _ in range(tournsize)]
        chosen.append(min(aspirants, key=lambda ind: ind.fitness.values))
    return chosen


def selRandom(individuals, k, rng: random.Random = random):
    return [rng.choice(individuals) for _ in range(k)]


def uniform_reference_points(n_obj: int, p: int):
    """Das-Dennis simplex lattice points."""
    out = []

    def rec(prefix, remaining):
        if len(prefix) == n_obj - 1:
            out.append(prefix + [remaining])
            return
        for i in range(remaining + 1):
            rec(prefix + [i], remaining - i)

    rec([], p)
    return np.array(out, dtype=float) / p


def _nsga3_normalize(F):
    """Adaptive normalization of Deb & Jain 2014 (Algorithms 2+3): translate
    by the ideal point, find per-axis extreme points via the achievement
    scalarizing function, and divide by the hyperplane intercepts those
    extremes span.  Falls back to the nadir (max) point when the hyperplane
    is degenerate (singular system or non-positive intercepts)."""
    n_obj = F.shape[1]
    ideal = F.min(axis=0)
    Ft = F - ideal
    # ASF with axis-aligned weights (eps off-axis): extreme point for axis j
    # minimizes max_i Ft_i / w_ij
    eps = 1e-6
    extremes = np.empty((n_obj, n_obj))
    for j in range(n_obj):
        w = np.full(n_obj, eps)
        w[j] = 1.0
        asf = (Ft / w).max(axis=1)
        extremes[j] = Ft[int(np.argmin(asf))]
    nadir = Ft.max(axis=0)
    intercepts = nadir.copy()
    try:
        b = np.linalg.solve(extremes, np.ones(n_obj))
        if np.all(b > 1e-12):
            cand = 1.0 / b
            # intercepts must be positive and not collapse below observed
            # translated values' scale (duplicate extremes -> huge values)
            if np.all(cand > 1e-12) and np.all(np.isfinite(cand)):
                intercepts = cand
    except np.linalg.LinAlgError:
        pass
    intercepts = np.where(intercepts > 1e-12, intercepts, 1.0)
    return Ft / intercepts


def selNSGA3(individuals, k, ref_points, rng: random.Random = random):
    """NSGA-III environmental selection (Deb & Jain 2014, Algorithm 1):
    non-dominated sort, ideal-point + extreme-point-intercept normalization,
    association to reference directions by perpendicular distance, and
    niche-preserving fill of the partial front with the published random
    tie-breaking."""
    fronts = sort_nondominated(individuals, k)
    chosen = []
    last_front = None
    for front in fronts:
        if len(chosen) + len(front) <= k:
            chosen.extend(front)
        else:
            last_front = front
            break
    if last_front is None or len(chosen) == k:
        return chosen[:k]

    pool = chosen + last_front
    F = np.array([ind.fitness.values for ind in pool], dtype=float)
    # clamp non-finite fitnesses to a large sentinel above the finite range
    finite_max = np.nanmax(np.where(np.isfinite(F), F, np.nan), axis=0,
                           initial=1.0)
    F = np.where(np.isfinite(F), F, finite_max * 10)
    Fn = _nsga3_normalize(F)

    # association: perpendicular distance to each reference direction
    norms = np.linalg.norm(ref_points, axis=1)
    norms[norms == 0] = 1.0
    dirs = ref_points / norms[:, None]
    proj = Fn @ dirs.T                                   # (pool, refs)
    dist = np.linalg.norm(Fn[:, None, :] - proj[:, :, None] * dirs[None],
                          axis=2)
    assoc = dist.argmin(axis=1)
    assoc_d = dist[np.arange(len(pool)), assoc]

    niche_count = defaultdict(int)
    for i in range(len(chosen)):
        niche_count[int(assoc[i])] += 1
    # members of the last front grouped by their reference point
    members = defaultdict(list)
    for j in range(len(last_front)):
        i = len(chosen) + j
        members[int(assoc[i])].append((float(assoc_d[i]), j))

    available = set(members.keys()) | {
        r for r in range(len(ref_points))}
    while len(chosen) < k:
        # J_min: least-niched reference points still available, random pick
        min_count = min(niche_count.get(r, 0) for r in available)
        jmin = [r for r in available if niche_count.get(r, 0) == min_count]
        r = jmin[rng.randrange(len(jmin))]
        if not members[r]:
            available.discard(r)   # no last-front member associates with it
            continue
        if niche_count.get(r, 0) == 0:
            # empty niche: take the closest associated member
            d, j = min(members[r])
            members[r].remove((d, j))
        else:
            d, j = members[r][rng.randrange(len(members[r]))]
            members[r].remove((d, j))
        chosen.append(last_front[j])
        niche_count[r] = niche_count.get(r, 0) + 1
    return chosen[:k]


class HallOfFame:
    """Best-k archive with string-based similarity dedup."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.items: List = []

    def update(self, population):
        for ind in population:
            if not ind.fitness.valid:
                continue
            if any(str(ind) == str(h) for h in self.items):
                continue
            self.items.append(ind.clone())
        self.items.sort(key=lambda ind: ind.fitness.values)
        del self.items[self.maxsize:]

    def clear(self):
        self.items.clear()

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class ParetoFront:
    """Non-dominated archive with string dedup."""

    def __init__(self):
        self.items: List = []

    def update(self, population):
        for ind in population:
            if not ind.fitness.valid:
                continue
            if any(str(ind) == str(h) for h in self.items):
                continue
            dominated = [h for h in self.items if ind.fitness.dominates(h.fitness)]
            if any(h.fitness.dominates(ind.fitness) for h in self.items):
                continue
            for h in dominated:
                self.items.remove(h)
            self.items.append(ind.clone())

    def clear(self):
        self.items.clear()

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def compile_statistics(population, objectives: Sequence[str]):
    """Per-objective avg/std/min/max + tree size stats (DEAP MultiStatistics
    analogue, reference optimization/program.py:659-661)."""
    record = {}
    finite = [ind for ind in population if ind.fitness.valid]
    for m, name in enumerate(objectives):
        vals = np.array([ind.fitness.values[m] for ind in finite]) \
            if finite else np.array([np.nan])
        vals = vals[np.isfinite(vals)]
        if len(vals) == 0:
            vals = np.array([np.nan])
        record[name] = {"avg": float(np.mean(vals)), "std": float(np.std(vals)),
                        "min": float(np.min(vals)), "max": float(np.max(vals))}
    sizes = np.array([len(ind) for ind in population])
    record["size"] = {"avg": float(sizes.mean()), "std": float(sizes.std()),
                      "min": int(sizes.min()), "max": int(sizes.max())}
    return record
