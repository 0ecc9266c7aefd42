"""The readers of the program's spans (harness/spans.py, metrics/*.py) on
a recorded run: calls that point at result logs with span rows, and the
same readers on logs without them."""
import pytest

from harness import spec

_BATCH = """stage visual: iters=5 cost=1.0e+00 wall=1.00s
stage inertial-full: iters=15 cost=1.0e+00 wall=3.00s
span vicalib.detect.match: n=12 s=%(match)f
span vicalib.engine.solve: n=1 s=%(solve)f
span vicalib.lm.assemble: n=20 s=1.500000
span vicalib.lm.iter: n=20 s=%(iter)f
span vicalib.lm.step: n=20 s=2.000000
span vicalib.lm.wait: n=20 s=0.200000
span vicalib.lm.weights: n=7 s=0.400000
count vicalib.detect.kernel_launches: 12
"""

_STREAM = """span vicalib.live.build: n=6 s=0.300000
span vicalib.live.publish: n=6 s=%(publish)f
span vicalib.live.solve: n=6 s=9.000000
"""


def _call(tmp_path, name, text, traced=False):
    out = tmp_path / name
    out.mkdir()
    (out / "vicalibrator.log").write_text(text)
    return {"out": str(out), "rc": 0, "traced": traced, "wall_s": 5.0,
            "timings": {"solve": 4.0}, "stages": [], "chunks": []}


def test_span_readers_parse_the_result_logs(tmp_path):
    calls = [
        # the profiled call is not read
        _call(tmp_path, "traced", _BATCH % dict(match=9, solve=9, iter=9)
              + _STREAM % dict(publish=9), traced=True),
        _call(tmp_path, "a", _BATCH % dict(match=0.1, solve=4.5, iter=4.0)
              + _STREAM % dict(publish=0.12)),
        _call(tmp_path, "b", _BATCH % dict(match=0.3, solve=5.5, iter=4.8)
              + _STREAM % dict(publish=0.24)),
        # a failed call is not read
        dict(_call(tmp_path, "failed", _BATCH % dict(
            match=9, solve=9, iter=9)), rc=1),
    ]
    rec = {"calls": calls}

    def read(name):
        return spec.reader(name)(rec)

    assert read("lm_host_ms.batch") == pytest.approx(
        1000 * ((4.0 - 0.2) / 20 + (4.8 - 0.2) / 20) / 2)
    assert read("lm_wait_ms.batch") == pytest.approx(10.0)
    assert read("imu_weights_s.batch") == pytest.approx(0.4)
    assert read("assemble_s.batch") == pytest.approx(1.5)
    assert read("lm_step_s.batch") == pytest.approx(2.0)
    assert read("solve_outside_lm_s.batch") == pytest.approx(
        (0.5 + 0.7) / 2)
    assert read("grid_match_s.batch") == pytest.approx(0.2)
    assert read("chunk_build_s.stream") == pytest.approx(0.05)
    assert read("chunk_solve_s.stream") == pytest.approx(1.5)
    assert read("chunk_publish_s.stream") == pytest.approx(0.03)

    # logs without span rows (a program without the spans), or no log at
    # all: every reader finds nothing and raises nothing
    bare = {"calls": [_call(tmp_path, "bare", "stage visual: iters=5 "
                            "cost=1.0e+00 wall=1.00s\n"),
                      dict(_call(tmp_path, "gone", ""),
                           out=str(tmp_path / "missing"))]}
    for name in ("lm_host_ms.batch", "lm_wait_ms.batch",
                 "imu_weights_s.batch", "assemble_s.batch",
                 "lm_step_s.batch", "solve_outside_lm_s.batch",
                 "grid_match_s.batch", "chunk_build_s.stream",
                 "chunk_solve_s.stream", "chunk_publish_s.stream"):
        assert spec.reader(name)(bare) is None, name
