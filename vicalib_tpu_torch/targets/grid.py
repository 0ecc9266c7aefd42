"""Calibration target grids: seeded random dot patterns and presets.

Equivalent capability to Calibu's ``MakePattern(rows, cols, seed)`` and
``LoadGridFromPreset`` used by the reference
(reference: src/vicalib-engine.cc:453-495).  A grid is an ``(rows, cols)``
int array of 0/1 (0 = small dot, 1 = large dot); the binary pattern
disambiguates the target's orientation and position.  3-D circle centers are
``(col * spacing, row * spacing, 0)`` — the layout implied by the reference's
observation assembly (vicalib-task.cc:355-358: ``pg3d = spacing * (pg0, pg1, 0)``
with ``pg = (col, row)``).

NOTE: the bit patterns produced here are deterministic for a given seed but are
not byte-identical to Calibu's generator (Calibu's RNG is not part of the
reference tree).  Structural properties match: seeded, reproducible, and unique
under the 4 grid symmetries so localisation is unambiguous.
"""
from __future__ import annotations

import numpy as np

_PRESETS = {
    # name: (rows, cols, seed, spacing_m, large_rad_m, small_rad_m)
    # Dimensions follow the reference defaults (vicalib-engine.cc:44-48, 90-93);
    # presets mirror the four named Calibu grids by role.
    "small": (10, 19, 71, 0.008, 0.00245, 0.00175),
    "medium": (10, 19, 71, 0.01355, 0.00423, 0.00283),
    "large": (24, 36, 57, 0.03, 0.009, 0.006),
    "letter": (10, 19, 71, 0.01355, 0.00423, 0.00283),
}


def _rotations(g: np.ndarray):
    yield g
    yield np.rot90(g, 1)
    yield np.rot90(g, 2)
    yield np.rot90(g, 3)


def _windows_unique(grid: np.ndarray, k: int = 4) -> bool:
    """True iff all k x k windows are unique across the 4 rotations."""
    seen = set()
    for rot in _rotations(grid):
        r, c = rot.shape
        if r < k or c < k:
            continue
        for i in range(r - k + 1):
            for j in range(c - k + 1):
                key = rot[i:i + k, j:j + k].tobytes()
                if key in seen:
                    return False
                seen.add(key)
    return True


def make_pattern(rows: int = 10, cols: int = 19, seed: int = 71) -> np.ndarray:
    """Seeded random binary dot pattern with unique k x k windows.

    Reference analog: calibu::MakePattern (called at vicalib-engine.cc:460-461
    with the -grid_height/-grid_width/-grid_seed flags).

    The window size adapts to the grid: 4x4 windows carry 16 bits, so once
    a grid has more than ~500 windows (x4 rotations) the birthday bound
    makes a collision-free 4x4 pattern essentially impossible — large grids
    (e.g. the 24x36 preset) use 5x5 windows instead.  Grids that fit the
    4x4 budget keep k=4, so existing patterns are bit-identical.
    """
    n_win = 4 * max(rows - 3, 0) * max(cols - 3, 0)
    k = 4 if n_win <= 1000 else 5
    for attempt in range(1000):
        rng = np.random.default_rng(seed + 100003 * attempt)
        grid = (rng.random((rows, cols)) < 0.5).astype(np.int32)
        if _windows_unique(grid, k=k):
            return grid
    raise RuntimeError("could not generate a unique pattern; try another seed")


class TargetGrid:
    """A dot-grid target: pattern bits + physical layout."""

    def __init__(self, grid: np.ndarray, spacing: float,
                 large_rad: float = 0.00423, small_rad: float = 0.00283):
        self.grid = np.asarray(grid, dtype=np.int32)
        self.rows, self.cols = self.grid.shape
        self.spacing = float(spacing)
        self.large_rad = float(large_rad)
        self.small_rad = float(small_rad)

    @property
    def n_points(self) -> int:
        return self.rows * self.cols

    def circles_3d(self) -> np.ndarray:
        """(rows*cols, 3) circle centers, row-major: index = row*cols + col."""
        cc, rr = np.meshgrid(np.arange(self.cols), np.arange(self.rows))
        pts = np.stack([cc.ravel(), rr.ravel(), np.zeros(self.n_points)], axis=1)
        return pts * np.array([self.spacing, self.spacing, 1.0])

    def code_3d(self) -> np.ndarray:
        """Centers of the *large* dots only (the binary code), (K, 3)."""
        pts = self.circles_3d()
        return pts[self.grid.ravel() == 1]

    def radii(self) -> np.ndarray:
        """(rows*cols,) physical dot radius per point."""
        return np.where(self.grid.ravel() == 1, self.large_rad, self.small_rad)


def make_target(rows=10, cols=19, seed=71, spacing=0.01355,
                large_rad=0.00423, small_rad=0.00283) -> TargetGrid:
    return TargetGrid(make_pattern(rows, cols, seed), spacing, large_rad,
                      small_rad)


def load_preset(name: str) -> TargetGrid:
    """Reference analog: calibu::LoadGridFromPreset (vicalib-engine.cc:464)."""
    if name not in _PRESETS:
        raise ValueError(
            f"unknown grid preset {name!r}; choose from {sorted(_PRESETS)}")
    rows, cols, seed, spacing, large, small = _PRESETS[name]
    return TargetGrid(make_pattern(rows, cols, seed), spacing, large, small)


def load_grid_file(path: str, spacing: float, large_rad: float,
                   small_rad: float) -> TargetGrid:
    """Load a target's 0/1 bit pattern from a file (-grid_file).

    Escape hatch for real printed targets: our generator is deterministic
    but not byte-identical to Calibu's (see module NOTE), so an existing
    physical Calibu grid cannot be regenerated from its seed — but its bit
    matrix can be dumped once (e.g. from calibu's Map()) and loaded here.
    Accepts .npy, or text (csv/whitespace) with one row per grid row.
    """
    if path.endswith(".npy"):
        grid = np.load(path)
    else:
        try:
            grid = np.loadtxt(path, delimiter=",")
        except ValueError:
            grid = np.loadtxt(path)
    grid = np.atleast_2d(np.asarray(grid))
    if not np.all((grid == 0) | (grid == 1)):
        raise ValueError(f"grid file {path} must contain only 0/1 entries")
    return TargetGrid(grid.astype(np.int32), spacing, large_rad, small_rad)
