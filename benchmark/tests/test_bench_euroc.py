"""The euroc.batch cell against the plain reference on the CPU, and the
readers of its two per-layer metrics.

The cell runs whole on the CPU at 48 frames a camera (the harness's look
for a card skipped): the program starts its poly2 cameras from the
target's homographies, calibrates, and has to agree with the plain
reference (plainref/: its own detections and one dense float64
Levenberg-Marquardt from the truth) within the cell's limits
(limits/euroc.batch.json).  At 24 frames a camera, 1.2 s of motion at 20
Hz, the plain solve does not reach its stopping decrement in its 60
iterations, so the cell is cut to 48 (2.4 s, the motion of vi_sim's 24
frames at 10 Hz).
"""
import pytest

from harness import runner, spec

N_FRAMES = 48
SEED = 2 ** 31 + 157


def test_euroc_agrees_with_the_reference():
    cell = spec.load_cell("euroc.batch")
    res, rec = runner.run_cell(cell, SEED, 0.0, False, "cpu",
                               n_frames=N_FRAMES, warm=False)
    assert res["failed"] == 0 and res["attempted"] == 1
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"], (name, c)
    assert res["correct"]
    # the visual stage's row is read from the call's result log
    assert spec.reader("visual_iters.batch")(rec) > 0


_LOG = """stage visual: iters=%(visual)d cost=1.0e+00 wall=1.00s
stage inertial-full: iters=15 cost=1.0e+00 wall=3.00s
span vicalib.engine.build: n=1 s=0.300000
span vicalib.engine.intr_start: n=1 s=%(start)f
count vicalib.engine.intr_start_frames: 64
"""


def _call(tmp_path, name, visual, start, traced=False, rc=0, log=True):
    out = tmp_path / name
    out.mkdir()
    if log:
        (out / "vicalibrator.log").write_text(_LOG % dict(visual=visual,
                                                          start=start))
    stages = [("visual", visual), ("inertial-full", 15)] if log else []
    return {"out": str(out), "rc": rc, "traced": traced, "wall_s": 5.0,
            "timings": {"build": 0.3}, "stages": stages, "chunks": []}


def test_start_and_visual_stage_readers(tmp_path):
    rec = {"calls": [
        # the profiled call and a failed call are not read
        _call(tmp_path, "traced", 99, 9.0, traced=True),
        _call(tmp_path, "a", 10, 0.1),
        _call(tmp_path, "b", 14, 0.3),
        _call(tmp_path, "failed", 99, 9.0, rc=1),
    ]}
    assert spec.reader("intr_start_s.batch")(rec) == pytest.approx(0.2)
    assert spec.reader("visual_iters.batch")(rec) == pytest.approx(12.0)

    # a program without the start's span (one from before the start), a
    # call without a visual stage (a resumed run): nothing
    bare = {"calls": [dict(_call(tmp_path, "bare", 10, 0.1),
                           stages=[("inertial-full+scale", 6)])]}
    (tmp_path / "bare" / "vicalibrator.log").write_text(
        "stage inertial-full+scale: iters=6 cost=1.0e+00 wall=1.00s\n")
    for name in ("intr_start_s.batch", "visual_iters.batch"):
        assert spec.reader(name)(bare) is None, name
