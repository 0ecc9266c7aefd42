"""Grid association: detected conics -> target grid coordinates.

Calibu TargetGridDot::FindTarget equivalent (call sites:
vicalib-task.cc:275-277, 351-363): given ellipse centers and sizes, recover
each dot's integer grid coordinate and disambiguate the target's orientation
and offset using the seeded large/small binary code.

Host-side numpy pre-pass by design (SURVEY.md section 7 "hard parts"): the
lattice BFS is branchy graph logic; the per-frame work is a few hundred
points.  Pipeline:

  1. seed at the most central detection; establish two local lattice axes
     from its nearest neighbors
  2. BFS: each indexed point predicts its 4 lattice neighbors with its own
     local axes (tolerant to perspective); matched points inherit updated
     axes
  3. radii -> large/small bits by comparing with the local median radius
  4. the detected bit-grid is matched against the target pattern over the 8
     grid symmetries x all translations; best agreement wins (the pattern's
     window uniqueness makes this unambiguous)
"""
from __future__ import annotations

import dataclasses

import numpy as np



@dataclasses.dataclass
class GridMatch:
    ok: bool
    # for each detection index: grid (col, row) or (-1, -1)
    grid_coords: np.ndarray       # (K, 2) int
    n_matched: int


def _bfs_lattice(centers: np.ndarray):
    """Integer-index points on a (possibly perspective) lattice.

    Returns (coords (N, 2) int or large sentinel for unindexed, ok).
    """
    N = len(centers)
    if N < 8:
        return None
    # neighbor structure
    d2 = np.sum((centers[:, None] - centers[None, :]) ** 2, axis=2)
    np.fill_diagonal(d2, np.inf)
    order = np.argsort(d2, axis=1)

    # seed: closest to centroid
    seed = int(np.argmin(np.sum((centers - centers.mean(0)) ** 2, axis=1)))
    nn = order[seed, :6]
    d1 = centers[nn[0]] - centers[seed]
    # second axis: smallest neighbor at angle > 30 deg from d1
    d2_axis = None
    for j in nn[1:]:
        v = centers[j] - centers[seed]
        cosang = abs(np.dot(v, d1)) / (np.linalg.norm(v) * np.linalg.norm(d1))
        if cosang < 0.866:
            d2_axis = v
            break
    if d2_axis is None:
        return None

    INVALID = np.iinfo(np.int32).min
    coords = np.full((N, 2), INVALID, dtype=np.int64)
    axes = np.zeros((N, 2, 2))
    coords[seed] = (0, 0)
    axes[seed] = np.stack([d1, d2_axis])
    taken = np.zeros(N, bool)
    taken[seed] = True
    frontier = [seed]
    steps = [(1, 0), (-1, 0), (0, 1), (0, -1)]

    while frontier:
        new_frontier = []
        for i in frontier:
            a1, a2 = axes[i]
            scale = 0.4 * min(np.linalg.norm(a1), np.linalg.norm(a2))
            for (si, sj) in steps:
                pred = centers[i] + si * a1 + sj * a2
                # nearest detection to the prediction
                dist = np.linalg.norm(centers - pred, axis=1)
                j = int(np.argmin(dist))
                if dist[j] > scale:
                    continue
                cj = coords[i] + (si, sj)
                if taken[j]:
                    continue
                coords[j] = cj
                # update local axes with the observed displacement
                obs = centers[j] - centers[i]
                if abs(si) == 1:
                    axes[j] = np.stack([obs * si, a2])
                else:
                    axes[j] = np.stack([a1, obs * sj])
                taken[j] = True
                new_frontier.append(j)
        frontier = new_frontier
    return coords, taken


def _classify_radii(radii, coords, taken):
    """Large/small bit per indexed dot, by ratio to the local median radius."""
    N = len(radii)
    bits = np.full(N, -1, dtype=np.int64)
    idx = np.where(taken)[0]
    if len(idx) == 0:
        return bits
    pts = coords[idx]
    for i in idx:
        # neighbors within Chebyshev distance 2 on the lattice
        d = np.max(np.abs(pts - coords[i]), axis=1)
        near = idx[(d > 0) & (d <= 2)]
        if len(near) < 3:
            continue
        med = np.median(radii[near])
        ratio = radii[i] / max(med, 1e-9)
        if ratio > 1.25:
            bits[i] = 1
        elif ratio < 0.85:
            bits[i] = 0
        else:
            # ambiguous relative to the median: compare against the two
            # cluster centers of local radii
            lo = np.percentile(radii[near], 25)
            hi = np.percentile(radii[near], 75)
            bits[i] = 1 if abs(radii[i] - hi) < abs(radii[i] - lo) else 0
    return bits


_SYMMETRIES = [
    # (transpose, flip_i, flip_j) applied to detected lattice coords
    (False, False, False), (False, False, True), (False, True, False),
    (False, True, True), (True, False, False), (True, False, True),
    (True, True, False), (True, True, True),
]


def _apply_sym(coords, sym):
    t, fi, fj = sym
    c = coords.copy()
    if t:
        c = c[:, ::-1]
    if fi:
        c = np.stack([-c[:, 0], c[:, 1]], axis=1)
    if fj:
        c = np.stack([c[:, 0], -c[:, 1]], axis=1)
    return c


def match_target(centers, radii, valid, pattern,
                 min_matched=16, min_agreement=0.8) -> GridMatch:
    """Associate detections with the target grid.

    centers: (K, 2) pixel centers; radii: (K,); valid: (K,) bool;
    pattern: the target's (rows, cols) 0/1 dot sizes.
    Returns GridMatch with per-detection grid (col, row) or (-1, -1).

    The plain matcher of the program's grid association (its native
    matcher returns the same).
    """
    K = len(centers)
    fail = GridMatch(ok=False,
                     grid_coords=np.full((K, 2), -1, dtype=np.int64),
                     n_matched=0)
    sel = np.where(valid)[0]
    if len(sel) < min_matched:
        return fail
    res = _bfs_lattice(centers[sel])
    if res is None:
        return fail
    coords, taken = res
    if np.sum(taken) < min_matched:
        return fail
    bits = _classify_radii(radii[sel], coords, taken)

    G = np.asarray(pattern)  # (rows, cols) of 0/1; x = col, y = row
    rows, cols = G.shape
    best = None
    for sym in _SYMMETRIES:
        c = _apply_sym(coords, sym)
        ti = np.where(taken)[0]
        ci = c[ti]
        bi = bits[ti]
        known = bi >= 0
        if known.sum() < min_matched // 2:
            continue
        # candidate translations: align detected bounding box inside grid
        imin, jmin = ci.min(axis=0)
        imax, jmax = ci.max(axis=0)
        # coords (i along axis1 = cols?, j axis2): try both i->col
        for di in range(-int(imin), cols - int(imax)):
            for dj in range(-int(jmin), rows - int(jmax)):
                col = ci[:, 0] + di
                row = ci[:, 1] + dj
                inb = (col >= 0) & (col < cols) & (row >= 0) & (row < rows)
                use = inb & known
                if use.sum() < min_matched // 2:
                    continue
                agree = np.mean(G[row[use], col[use]] == bi[use])
                score = agree * use.sum()
                if best is None or score > best[0]:
                    best = (score, agree, sym, di, dj)
    if best is None:
        return fail
    score, agree, sym, di, dj = best
    if agree < min_agreement:
        return fail

    c = _apply_sym(coords, sym)
    out = np.full((K, 2), -1, dtype=np.int64)
    ti = np.where(taken)[0]
    col = c[ti, 0] + di
    row = c[ti, 1] + dj
    inb = (col >= 0) & (col < cols) & (row >= 0) & (row < rows)
    out[sel[ti[inb]], 0] = col[inb]
    out[sel[ti[inb]], 1] = row[inb]

    # refinement: fit a grid->pixel homography on the BFS matches, predict
    # every grid point, and re-associate detections globally.  Recovers dots
    # the BFS chain missed and drops bad merged-blob associations.
    out = _homography_reassociate(centers, np.asarray(valid, bool), out,
                                  rows, cols)
    return GridMatch(ok=True, grid_coords=out,
                     n_matched=int(np.sum(out[:, 0] >= 0)))


def _homography_reassociate(centers, valid, grid_coords, rows, cols,
                            tol_frac=0.3):
    matched = grid_coords[:, 0] >= 0
    if matched.sum() < 8:
        return grid_coords
    src = grid_coords[matched].astype(np.float64)      # (col, row)
    dst = centers[matched]
    # DLT homography (normalized)
    def normalize(p):
        mu = p.mean(0)
        sc = np.sqrt(((p - mu) ** 2).sum(1).mean()) + 1e-12
        T = np.array([[1 / sc, 0, -mu[0] / sc], [0, 1 / sc, -mu[1] / sc],
                      [0, 0, 1]])
        return (p - mu) / sc, T

    sn, Ts = normalize(src)
    dn, Td = normalize(dst)
    x, y = sn[:, 0], sn[:, 1]
    u, v = dn[:, 0], dn[:, 1]
    z = np.zeros_like(x)
    o = np.ones_like(x)
    A = np.concatenate([
        np.stack([x, y, o, z, z, z, -u * x, -u * y, -u], 1),
        np.stack([z, z, z, x, y, o, -v * x, -v * y, -v], 1)])
    _, _, Vt = np.linalg.svd(A, full_matrices=False)
    Hn = Vt[-1].reshape(3, 3)
    H = np.linalg.solve(Td, Hn @ Ts)

    gc, gr = np.meshgrid(np.arange(cols), np.arange(rows))
    gpts = np.stack([gc.ravel(), gr.ravel(), np.ones(rows * cols)], 1)
    proj = gpts @ H.T
    proj = proj[:, :2] / proj[:, 2:3]                  # (rows*cols, 2)

    # local spacing from neighboring grid predictions
    spacing = np.median(np.linalg.norm(
        proj.reshape(rows, cols, 2)[:, 1:] -
        proj.reshape(rows, cols, 2)[:, :-1], axis=2))
    tol = tol_frac * spacing

    K = len(centers)
    new = np.full((K, 2), -1, dtype=np.int64)
    det_idx = np.where(valid)[0]
    if len(det_idx) == 0:
        return grid_coords
    det = centers[det_idx]
    d = np.linalg.norm(det[:, None] - proj[None], axis=2)   # (Nd, R*C)
    # greedy one-to-one: each grid point takes its nearest detection
    best_det = np.argmin(d, axis=0)
    best_dist = d[best_det, np.arange(d.shape[1])]
    # and each detection must agree it's the nearest grid point
    best_grid_for_det = np.argmin(d, axis=1)
    for g in np.argsort(best_dist):
        if best_dist[g] > tol:
            break
        i = det_idx[best_det[g]]
        if new[i, 0] >= 0:
            continue
        if best_grid_for_det[best_det[g]] != g:
            continue
        new[i] = (g % cols, g // cols)
    return new
