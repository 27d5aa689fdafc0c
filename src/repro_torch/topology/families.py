"""Agent communication graphs and mixing-weight rules: the port's copy
of ``repro.topology.families``. Pure numpy (``default_rng``), so every
adjacency and mixing matrix is bit-equal to the reference's.

Generators return a boolean symmetric adjacency with empty diagonal:
regular (stub matching), er, star (node 0 is the server), ring,
geometric, smallworld (Watts–Strogatz), pref (Barabási–Albert), torus.
Weight rules turn an adjacency into a symmetric doubly-stochastic mixing
matrix S: metropolis, lazy_metropolis, laplacian (I − εL);
``metropolis_weights_loop`` is the double-loop oracle the vectorized
rule is held against. Spectral diagnostics: algebraic connectivity
(Fiedler value) and the SLEM of a mixing matrix.
"""
from __future__ import annotations

import numpy as np


# --------------------------------------------------------------- generators
def regular_graph(n, degree, seed=0):
    """Random k-regular graph via stub matching (retry until simple and
    connected)."""
    rng = np.random.default_rng(seed)
    assert (n * degree) % 2 == 0, "n*degree must be even"
    for _ in range(200):
        stubs = np.repeat(np.arange(n), degree)
        rng.shuffle(stubs)
        pairs = stubs.reshape(-1, 2)
        A = np.zeros((n, n), bool)
        ok = True
        for u, v in pairs:
            if u == v or A[u, v]:
                ok = False
                break
            A[u, v] = A[v, u] = True
        if ok and is_connected(A):
            return A
    raise RuntimeError("could not sample a simple connected regular graph")


def er_graph(n, p, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        U = rng.random((n, n)) < p
        A = np.triu(U, 1)
        A = A | A.T
        if is_connected(A):
            return A
    raise RuntimeError("ER graph disconnected after retries; raise p")


def star_graph(n):
    """Node 0 is the server."""
    A = np.zeros((n, n), bool)
    A[0, 1:] = True
    A[1:, 0] = True
    return A


def ring_graph(n, hops=1):
    """Circulant ring: node i ~ i±1..i±hops. Degree = 2*hops."""
    A = np.zeros((n, n), bool)
    for h in range(1, hops + 1):
        idx = np.arange(n)
        A[idx, (idx + h) % n] = True
        A[(idx + h) % n, idx] = True
    return A


def geometric_graph(n, radius=None, seed=0):
    """Random geometric graph: n points uniform on the unit square, edge
    iff distance ≤ radius. Default radius sits at the connectivity
    threshold √(2 ln n / n); the radius grows 10% per retry until the
    sample is connected, so the returned graph is always connected but
    stays near-threshold sparse."""
    rng = np.random.default_rng(seed)
    r = float(radius) if radius is not None else \
        float(np.sqrt(2.0 * np.log(max(n, 2)) / n))
    for _ in range(200):
        pts = rng.random((n, 2))
        d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
        A = d2 <= r * r
        np.fill_diagonal(A, False)
        if is_connected(A):
            return A
        r *= 1.1
    raise RuntimeError("geometric graph disconnected after retries")


def small_world_graph(n, k=4, beta=0.2, seed=0):
    """Watts–Strogatz small world: ring lattice of even degree ``k``,
    each lattice edge (i, i+h) rewired with probability ``beta`` to a
    uniformly random non-neighbor. beta=0 is the circulant ring, beta=1
    is (approximately) a random graph; retried until connected."""
    assert k % 2 == 0 and 2 <= k < n, "k must be even and in [2, n)"
    rng = np.random.default_rng(seed)
    for _ in range(200):
        A = ring_graph(n, k // 2)
        for h in range(1, k // 2 + 1):
            for i in range(n):
                j = (i + h) % n
                if A[i, j] and rng.random() < beta:
                    cand = np.nonzero(~A[i])[0]
                    cand = cand[cand != i]
                    if cand.size:
                        A[i, j] = A[j, i] = False
                        t = int(rng.choice(cand))
                        A[i, t] = A[t, i] = True
        if is_connected(A):
            return A
    raise RuntimeError("small-world graph disconnected after retries")


def preferential_attachment_graph(n, m=2, seed=0):
    """Barabási–Albert scale-free graph: seed clique on m+1 nodes, then
    each new node attaches ``m`` links to distinct existing nodes chosen
    with probability proportional to degree. Connected by construction."""
    assert 1 <= m < n, "need 1 <= m < n"
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n), bool)
    for i in range(m + 1):
        for j in range(i):
            A[i, j] = A[j, i] = True
    for v in range(m + 1, n):
        deg = A[:v, :v].sum(1).astype(float)
        chosen: set[int] = set()
        while len(chosen) < m:
            t = int(rng.choice(v, p=deg / deg.sum()))
            chosen.add(t)
        for t in chosen:
            A[v, t] = A[t, v] = True
    return A


def torus_graph(n, rows=None):
    """2-D torus: n factored into rows × cols with rows the largest
    divisor ≤ √n (pass ``rows`` to override). Node (r, c) ~ (r±1, c) and
    (r, c±1) with wrap-around — degree 4 on grids with both sides ≥ 3;
    prime n degenerates to the 1 × n ring."""
    if rows is None:
        rows = max(d for d in range(1, int(np.sqrt(n)) + 1) if n % d == 0)
    assert n % rows == 0, "rows must divide n"
    cols = n // rows
    A = np.zeros((n, n), bool)
    r, c = np.divmod(np.arange(n), cols)
    for dr, dc in ((1, 0), (0, 1)):
        nb = ((r + dr) % rows) * cols + (c + dc) % cols
        keep = nb != np.arange(n)          # rows==1 (or cols==1) wrap-self
        A[np.arange(n)[keep], nb[keep]] = True
        A[nb[keep], np.arange(n)[keep]] = True
    return A


def is_connected(A):
    n = len(A)
    seen = np.zeros(n, bool)
    stack = [0]
    seen[0] = True
    while stack:
        u = stack.pop()
        for v in np.nonzero(A[u])[0]:
            if not seen[v]:
                seen[v] = True
                stack.append(v)
    return bool(seen.all())


# ------------------------------------------------------------- weight rules
def metropolis_weights_loop(A):
    """O(n²) double-loop Metropolis reference — kept verbatim as the
    regression oracle for the vectorized ``metropolis_weights``."""
    A = np.asarray(A, bool)
    deg = A.sum(1)
    n = len(A)
    W = np.zeros((n, n))
    for u in range(n):
        for v in np.nonzero(A[u])[0]:
            W[u, v] = 1.0 / (1 + max(deg[u], deg[v]))
        W[u, u] = 1.0 - W[u].sum()
    return W


def metropolis_weights(A):
    """Symmetric doubly-stochastic mixing matrix from adjacency A:
    W_uv = 1 / (1 + max(deg u, deg v)) on edges, the diagonal takes the
    rest of each row."""
    A = np.asarray(A, bool)
    deg = A.sum(1)
    n = len(A)
    pair = np.maximum(deg[:, None], deg[None, :])
    W = np.where(A, 1.0 / (1.0 + pair), 0.0)
    idx = np.arange(n)
    W[idx, idx] = 0.0
    W[idx, idx] = 1.0 - W.sum(1)
    return W


def lazy_metropolis_weights(A, lazy=0.5):
    """(1−γ)·Metropolis + γ·I — the lazy chain: still symmetric doubly
    stochastic, with every eigenvalue ≥ 2γ−1 (no bipartite −1 mode)."""
    n = len(A)
    return lazy * np.eye(n) + (1.0 - lazy) * metropolis_weights(A)


def laplacian_weights(A, eps=None):
    """I − εL consensus matrix. Default ε = 1/(deg_max + 1) keeps every
    entry non-negative and the chain strictly aperiodic."""
    A = np.asarray(A, bool)
    deg = A.sum(1)
    if eps is None:
        eps = 1.0 / (float(deg.max()) + 1.0)
    L = np.diag(deg.astype(float)) - A.astype(float)
    return np.eye(len(A)) - float(eps) * L


WEIGHT_RULES = {
    "metropolis": metropolis_weights,
    "lazy_metropolis": lazy_metropolis_weights,
    "laplacian": laplacian_weights,
}


# -------------------------------------------------------------- diagnostics
def algebraic_connectivity(A):
    """Fiedler value λ₂(L) of the graph Laplacian: > 0 iff connected;
    larger = better-connected (faster consensus)."""
    A = np.asarray(A, bool)
    L = np.diag(A.sum(1).astype(float)) - A.astype(float)
    return float(np.sort(np.linalg.eigvalsh(L))[1])


def second_eigenvalue(S):
    """SLEM of a symmetric mixing matrix: max(|λ₂|, |λ_n|), the
    per-mixing-round consensus contraction factor (< 1 ⟺ the chain
    mixes; smaller = faster)."""
    vals = np.sort(np.abs(np.linalg.eigvalsh(np.asarray(S, float))))
    return float(vals[-2])


# ---------------------------------------------------------------- frontend
def build_topology(kind, n, *, degree=3, p=0.1, seed=0,
                   weights="metropolis", radius=None, beta=0.2, m=2,
                   lazy=0.5, eps=None):
    """(adjacency, mixing matrix) for a named family + weight rule.

    ``kind``: regular | er | star | ring | geometric | smallworld |
    pref | torus. ``weights``: metropolis | lazy_metropolis | laplacian.
    """
    if kind == "regular":
        A = regular_graph(n, degree, seed)
    elif kind == "er":
        A = er_graph(n, p, seed)
    elif kind == "star":
        A = star_graph(n)
    elif kind == "ring":
        A = ring_graph(n, max(1, degree // 2))
    elif kind == "geometric":
        A = geometric_graph(n, radius=radius, seed=seed)
    elif kind == "smallworld":
        A = small_world_graph(n, k=max(2, 2 * (degree // 2)), beta=beta,
                              seed=seed)
    elif kind == "pref":
        A = preferential_attachment_graph(n, m=m, seed=seed)
    elif kind == "torus":
        A = torus_graph(n)
    else:
        raise ValueError(kind)
    try:
        rule = WEIGHT_RULES[weights]
    except KeyError:
        raise ValueError(f"unknown weight rule {weights!r}; "
                         f"one of {sorted(WEIGHT_RULES)}") from None
    kw = ({"lazy": lazy} if weights == "lazy_metropolis"
          else {"eps": eps} if weights == "laplacian" else {})
    return A, rule(A, **kw)
