"""The port imports neither JAX nor the JAX package.

Every ``.py`` file under ``vicalib_tpu_torch/`` and ``chip_smoke.py`` is
searched for ``import jax``, ``from jax``, ``vicalib_tpu.`` and
``from vicalib_tpu `` (the port's own name, ``vicalib_tpu_torch``, is
allowed).  The port keeps its own copies of the JAX package's numpy-only
modules, and those copies must agree with the originals.
"""
import pathlib
import re

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = [
    re.compile(r"^\s*import\s+jax\b", re.M),
    re.compile(r"^\s*from\s+jax\b", re.M),
    re.compile(r"\bvicalib_tpu\.(?!_)"),
    re.compile(r"\bfrom\s+vicalib_tpu\s"),
    re.compile(r"^\s*import\s+vicalib_tpu\b(?!_torch)", re.M),
]


def _port_files():
    files = sorted((ROOT / "vicalib_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert "vicalib_tpu_torch/detect/kernels.py" in names
    for mod in ("checkpoint", "streaming", "tracker", "viz", "report",
                "status", "dist/mesh", "dist/sharded", "dist/multihost",
                "io/uvc"):
        assert "vicalib_tpu_torch/%s.py" % mod in names
    assert "chip_smoke.py" in names
    assert (ROOT / "vicalib_tpu_torch/csrc/threshold_label.cu").exists()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    text = path.read_text()
    for pat in FORBIDDEN:
        m = pat.search(text)
        assert m is None, "%s: %r" % (path, m.group(0))


def test_host_copies_agree_with_the_originals():
    from vicalib_tpu.dist import mesh as j_mesh
    from vicalib_tpu.geometry import quat_np as j_q
    from vicalib_tpu.io import uvc as j_uvc
    from vicalib_tpu.targets import grid as j_grid
    from vicalib_tpu.targets import grid_match as j_gm
    from vicalib_tpu_torch.dist import mesh as t_mesh
    from vicalib_tpu_torch.geometry import quat_np as t_q
    from vicalib_tpu_torch.io import uvc as t_uvc
    from vicalib_tpu_torch.targets import grid as t_grid
    from vicalib_tpu_torch.targets import grid_match as t_gm

    for rows, cols, seed in ((10, 19, 71), (24, 36, 57)):
        np.testing.assert_array_equal(t_grid.make_pattern(rows, cols, seed),
                                      j_grid.make_pattern(rows, cols, seed))
    rng = np.random.default_rng(0)
    w = rng.normal(size=(5, 3))
    np.testing.assert_array_equal(t_q.exp(w), j_q.exp(w))
    np.testing.assert_array_equal(t_q.log(t_q.exp(w)), j_q.log(j_q.exp(w)))
    for n in (6, 7):
        a = rng.normal(size=(n, 3))
        np.testing.assert_array_equal(t_mesh.pad_to_multiple(a, 4),
                                      j_mesh.pad_to_multiple(a, 4))
    # V4L2 luma extraction on tightly packed YUYV rows
    raw = rng.integers(0, 256, 2 * 30 * 8, dtype=np.uint8).tobytes()
    np.testing.assert_array_equal(t_uvc._yuyv_to_grey(raw, 30, 8),
                                  j_uvc._yuyv_to_grey(raw, 30, 8))
    # the python grid matcher on a clean synthetic lattice
    target = t_grid.make_target()
    pts = target.circles_3d()[:, :2] * 4000.0 + 50.0
    radii = np.where(target.grid.ravel() == 1, 5.0, 3.4)
    valid = np.ones(len(pts), bool)
    m_t = t_gm.match_target(pts, radii, valid, target, backend="numpy")
    m_j = j_gm.match_target(pts, radii, valid, j_grid.make_target(),
                            backend="numpy")
    assert m_t.ok and m_j.ok
    np.testing.assert_array_equal(m_t.grid_coords, m_j.grid_coords)
