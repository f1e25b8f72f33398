"""Ragged candidate rows for the prune tests, with numpy alone (the card's
test run has no JAX): every extent a tile edge can get wrong, and holes."""
import numpy as np

# every 32-candidate tile edge of the prune's M <= 128 and M <= 256 instances
EXTENTS = (0, 1, 31, 32, 33, 64, 65, 127, 128, 129, 159, 160, 161, 193, 225, 255, 256)


def _dists(a, b, metric):
    if metric == "l2":
        return ((b - a) ** 2).sum(-1)
    if metric == "ip":
        return -(b * a).sum(-1)
    nb = np.maximum(np.linalg.norm(b, axis=-1), 1e-12)
    return 1.0 - (b * a).sum(-1) / (nb * max(np.linalg.norm(a), 1e-12))


def ragged_rows(x, m, seed, metric="l2", repeats=1):
    """Candidate rows over the corpus ``x`` (n, d): row r is vertex r's
    list. Each extent of EXTENTS up to ``m`` (and ``m`` itself) appears
    ``repeats`` times dense (valid-first, by distance) and ``repeats`` times
    with holes: slots below the last valid one, which stays, turned into
    padding, half of them -1 and half ids >= n. Returns numpy
    ``(planted, ids, dists, flags)``: ``planted`` holds the ids >= n (the
    kernels read them as padding), ``ids`` -1 in their place (what the plain
    versions take)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    ext = sorted({e for e in EXTENTS if e <= m} | {m})
    kinds = [(e, hole) for _ in range(repeats) for hole in (False, True) for e in ext]
    ids = np.full((len(kinds), m), -1, np.int32)
    dists = np.full((len(kinds), m), np.inf, np.float32)
    flags = np.zeros((len(kinds), m), np.uint8)
    planted = ids.copy()
    for r, (e, hole) in enumerate(kinds):
        cand = rng.choice(np.delete(np.arange(n), r), size=e, replace=False)
        dist = _dists(x[r], x[cand], metric).astype(np.float32)
        order = np.argsort(dist, kind="stable")
        ids[r, :e], dists[r, :e] = cand[order], dist[order]
        flags[r, :e] = rng.integers(0, 2, e)
        planted[r] = ids[r]
        if hole and e > 2:
            slots = rng.choice(e - 1, size=max(1, e // 8), replace=False)
            ids[r, slots], dists[r, slots], flags[r, slots] = -1, np.inf, 0
            planted[r, slots] = np.where(np.arange(slots.size) % 2 == 0, -1, n + 3 + slots)
    return planted, ids, dists, flags


VALID = (0, 1, 7, 17, 31, 32, 33, 64)


def beam_rows(n, m, seed):
    """(n, m) adjacency rows shaped like a built graph's, for the beam
    tests: valid-first, row r holding the r-th (cyclically) of the VALID
    counts up to ``m`` and ``m`` itself; every third row has holes below
    its last valid slot, half -1 and half ids >= n. Returns numpy
    ``(planted, ids)``: ``planted`` holds the ids >= n (the kernels read them
    as padding), ``ids`` -1 in their place (what the plain versions take)."""
    rng = np.random.default_rng(seed)
    counts = sorted({c for c in VALID if c <= m} | {m})
    ids = np.full((n, m), -1, np.int32)
    planted = ids.copy()
    for r in range(n):
        v = counts[r % len(counts)]
        ids[r, :v] = rng.choice(n, size=v, replace=False)
        planted[r] = ids[r]
        if r % 3 == 2 and v > 2:
            slots = rng.choice(v - 1, size=max(1, v // 8), replace=False)
            ids[r, slots] = -1
            planted[r, slots] = np.where(np.arange(slots.size) % 2 == 0, -1, n + 3 + slots)
    return planted, ids
