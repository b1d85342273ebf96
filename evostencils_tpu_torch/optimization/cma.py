"""Copy of evostencils_tpu/optimization/cma.py, kept in the port so that it
imports nothing of the JAX package.  numpy only, so for a given seed the
ask/tell stream is bitwise the JAX package's.

Minimal CMA-ES (covariance matrix adaptation evolution strategy).

Native replacement for the DEAP ``cma.Strategy`` the reference drives in
its transfer-weight tuner (reference optimization/intergrid_transfer.py:
126-131).  Standard (mu/mu_w, lambda)-CMA-ES with cumulative step-size
adaptation and rank-one + rank-mu covariance updates; ask/tell interface so
the caller can evaluate a whole generation in one batched device call.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


class CMAES:
    def __init__(self, centroid, sigma: float, lambda_: Optional[int] = None,
                 seed: int = 0):
        self.mean = np.asarray(centroid, dtype=np.float64).copy()
        n = self.mean.size
        self.n = n
        self.sigma = float(sigma)
        self.lambda_ = lambda_ or (4 + int(3 * math.log(n)))
        self.mu = self.lambda_ // 2
        w = math.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.weights = w / w.sum()
        self.mueff = 1.0 / np.sum(self.weights ** 2)

        self.cc = (4 + self.mueff / n) / (n + 4 + 2 * self.mueff / n)
        self.cs = (self.mueff + 2) / (n + self.mueff + 5)
        self.c1 = 2 / ((n + 1.3) ** 2 + self.mueff)
        self.cmu = min(1 - self.c1,
                       2 * (self.mueff - 2 + 1 / self.mueff)
                       / ((n + 2) ** 2 + self.mueff))
        self.damps = 1 + 2 * max(
            0.0, math.sqrt((self.mueff - 1) / (n + 1)) - 1) + self.cs
        self.chi_n = math.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n * n))

        self.pc = np.zeros(n)
        self.ps = np.zeros(n)
        self.C = np.eye(n)
        self._decompose()
        self.rng = np.random.default_rng(seed)
        self.generation = 0

    def _decompose(self):
        eigvals, B = np.linalg.eigh(self.C)
        eigvals = np.maximum(eigvals, 1e-20)
        self.B = B
        self.D = np.sqrt(eigvals)
        self.invsqrtC = B @ np.diag(1.0 / self.D) @ B.T

    def ask(self) -> np.ndarray:
        """Sample a ``(lambda, n)`` population."""
        z = self.rng.standard_normal((self.lambda_, self.n))
        self._y = z @ np.diag(self.D) @ self.B.T
        return self.mean + self.sigma * self._y

    def tell(self, solutions: np.ndarray, fitnesses) -> None:
        """Rank-based update; lower fitness is better."""
        order = np.argsort(np.asarray(fitnesses, dtype=np.float64))
        sel = np.asarray(solutions)[order[:self.mu]]
        y_sel = (sel - self.mean) / self.sigma
        y_w = self.weights @ y_sel
        self.mean = self.mean + self.sigma * y_w

        self.ps = ((1 - self.cs) * self.ps
                   + math.sqrt(self.cs * (2 - self.cs) * self.mueff)
                   * (self.invsqrtC @ y_w))
        ps_norm = np.linalg.norm(self.ps)
        hsig = (ps_norm
                / math.sqrt(1 - (1 - self.cs) ** (2 * (self.generation + 1)))
                / self.chi_n) < (1.4 + 2 / (self.n + 1))
        self.pc = ((1 - self.cc) * self.pc
                   + hsig * math.sqrt(self.cc * (2 - self.cc) * self.mueff)
                   * y_w)

        artmp = y_sel
        delta_hsig = (1 - hsig) * self.cc * (2 - self.cc)
        self.C = ((1 - self.c1 - self.cmu) * self.C
                  + self.c1 * (np.outer(self.pc, self.pc)
                               + delta_hsig * self.C)
                  + self.cmu * (artmp.T * self.weights) @ artmp)
        self.sigma *= math.exp(min(
            1.0, (self.cs / self.damps) * (ps_norm / self.chi_n - 1)))
        self._decompose()
        self.generation += 1
