"""Graph topologies for decentralized learning (paper §I, §IV.A).

A topology is an undirected graph over K agents.  ``N_k`` (the neighbourhood
of agent k) *includes k itself*, matching the diffusion literature: the degree
``n_k = |N_k|`` therefore counts the self loop.

Provides the paper's three experimental topologies (ring, Erdos-Renyi p=0.1,
hypercube) plus extras (full, star, chain, 2-d torus), the Metropolis mixing
matrix (eq. 5), and the mixing rate lambda_2.

A numpy copy of ``repro.core.topology`` (the port imports nothing of the JAX
package); every matrix it builds is bit-identical to the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    name: str
    adjacency: np.ndarray  # (K, K) bool, symmetric, zero diagonal

    def __post_init__(self):
        A = np.asarray(self.adjacency, dtype=bool)
        if A.ndim != 2 or A.shape[0] != A.shape[1]:
            raise ValueError("adjacency must be square")
        if not np.array_equal(A, A.T):
            raise ValueError("adjacency must be symmetric (undirected graph)")
        if np.any(np.diag(A)):
            raise ValueError("adjacency must have a zero diagonal")
        object.__setattr__(self, "adjacency", A)

    # -- basic properties ----------------------------------------------------

    @property
    def num_agents(self) -> int:
        return self.adjacency.shape[0]

    @property
    def degrees(self) -> np.ndarray:
        """n_k = |N_k| *including* the self loop."""
        return self.adjacency.sum(axis=1).astype(np.int64) + 1

    def neighbors(self, k: int, include_self: bool = False) -> np.ndarray:
        nbrs = np.flatnonzero(self.adjacency[k])
        if include_self:
            nbrs = np.sort(np.append(nbrs, k))
        return nbrs

    def is_connected(self) -> bool:
        K = self.num_agents
        seen = np.zeros(K, dtype=bool)
        stack = [0]
        seen[0] = True
        while stack:
            u = stack.pop()
            for v in np.flatnonzero(self.adjacency[u]):
                if not seen[v]:
                    seen[v] = True
                    stack.append(int(v))
        return bool(seen.all())

    # -- mixing matrices ------------------------------------------------------

    def c_matrix(self) -> np.ndarray:
        """The paper's C = [c_lk]: positive iff l in N_k (self loops included).

        Binary by default; only the sparsity pattern (plus c_kk) enters the
        DRT construction, the magnitudes rescale the unnormalized weights
        uniformly per edge.
        """
        C = self.adjacency.astype(np.float64).copy()
        np.fill_diagonal(C, 1.0)
        return C

    def metropolis(self) -> np.ndarray:
        """Metropolis-Hastings weights, eq. (5).  Doubly stochastic."""
        K = self.num_agents
        n = self.degrees
        A = np.zeros((K, K), dtype=np.float64)
        for k in range(K):
            for l in np.flatnonzero(self.adjacency[k]):
                A[l, k] = 1.0 / max(n[k], n[l])
        for k in range(K):
            A[k, k] = 1.0 - A[:, k].sum()
        return A

    def lambda2(self) -> float:
        """Mixing rate: second-largest |eigenvalue| of the Metropolis matrix."""
        ev = np.linalg.eigvals(self.metropolis())
        mags = np.sort(np.abs(ev))[::-1]
        return float(mags[1])


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


def ring(K: int) -> Topology:
    A = np.zeros((K, K), dtype=bool)
    for k in range(K):
        A[k, (k + 1) % K] = True
        A[(k + 1) % K, k] = True
    return Topology("ring", A)


def chain(K: int) -> Topology:
    A = np.zeros((K, K), dtype=bool)
    for k in range(K - 1):
        A[k, k + 1] = A[k + 1, k] = True
    return Topology("chain", A)


def full(K: int) -> Topology:
    A = np.ones((K, K), dtype=bool)
    np.fill_diagonal(A, False)
    return Topology("full", A)


def star(K: int) -> Topology:
    A = np.zeros((K, K), dtype=bool)
    A[0, 1:] = True
    A[1:, 0] = True
    return Topology("star", A)


def hypercube(K: int) -> Topology:
    d = int(np.log2(K))
    if 2**d != K:
        raise ValueError(f"hypercube needs K a power of two (K = 2^d), got K={K}")
    A = np.zeros((K, K), dtype=bool)
    for k in range(K):
        for bit in range(d):
            j = k ^ (1 << bit)
            A[k, j] = A[j, k] = True
    return Topology("hypercube", A)


def torus2d(K: int) -> Topology:
    s = int(round(np.sqrt(K)))
    if s * s != K:
        raise ValueError(f"torus2d needs K a perfect square (K = s^2), got K={K}")
    A = np.zeros((K, K), dtype=bool)

    def idx(r, c):
        return (r % s) * s + (c % s)

    for r in range(s):
        for c in range(s):
            u = idx(r, c)
            for v in (idx(r + 1, c), idx(r, c + 1)):
                if u != v:
                    A[u, v] = A[v, u] = True
    return Topology("torus2d", A)


def erdos_renyi(K: int, p: float = 0.1, seed: int = 0, max_tries: int = 200) -> Topology:
    """Erdos-Renyi G(K, p), resampled until connected (paper uses p=0.1).

    Falls back to adding a ring after ``max_tries`` failures so the builder is
    total (Assumption 1 requires strong connectivity).
    """
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        U = rng.random((K, K)) < p
        A = np.triu(U, k=1)
        A = A | A.T
        topo = Topology("erdos_renyi", A)
        if topo.is_connected():
            return topo
    A = A | ring(K).adjacency
    return Topology("erdos_renyi+ring", A)


# canonical ER instance for the paper-reproduction experiments: seed chosen so
# lambda2 ~= 0.911, matching Table I's 0.905 (ER(16, 0.1) lambda2 is strongly
# instance-dependent; some seeds exceed the ring's 0.949)
PAPER_ER_SEED = 29

_BUILDERS = {
    "ring": ring,
    "chain": chain,
    "full": full,
    "star": star,
    "hypercube": hypercube,
    "torus2d": torus2d,
    "erdos_renyi": erdos_renyi,
}


def make_topology(name: str, K: int, **kwargs) -> Topology:
    """Build a named topology over ``K`` agents.

    Validates the factory surface up front: the name must be registered,
    ``K`` must be an int with at least 2 agents, and every kwarg must be
    accepted by the builder — an unknown kwarg is a TypeError naming the
    valid ones, never silently dropped.  Builder-specific ``K`` constraints
    (hypercube: power of two; torus2d: perfect square) are enforced by the
    builders themselves with equally clear errors.
    """
    if name not in _BUILDERS:
        raise KeyError(f"unknown topology {name!r}; have {sorted(_BUILDERS)}")
    if isinstance(K, bool) or not isinstance(K, (int, np.integer)):
        raise TypeError(f"K must be an int, got {type(K).__name__}")
    if K < 2:
        raise ValueError(f"topology {name!r} needs K >= 2 agents, got K={K}")
    builder = _BUILDERS[name]
    import inspect

    params = inspect.signature(builder).parameters
    valid = [p for p in params if p != "K"]
    unknown = sorted(set(kwargs) - set(valid))
    if unknown:
        raise TypeError(
            f"topology {name!r} got unknown kwargs {unknown}; valid kwargs: "
            f"{valid or 'none'}"
        )
    return builder(K, **kwargs)
