"""The readers of the IMU factor kernel's share (metrics/
imu_kernel_pct.*.py) on recorded result logs: with the program's
``count vicalib.imu.factors`` and ``vicalib.imu.kernel_factors`` rows, and
without them."""
import pytest

from harness import spec


def _call(tmp_path, name, text, traced=False):
    out = tmp_path / name
    out.mkdir()
    (out / "vicalibrator.log").write_text(text)
    return {"out": str(out), "rc": 0, "traced": traced, "wall_s": 5.0,
            "timings": {"solve": 4.0}, "stages": [], "chunks": []}


@pytest.mark.parametrize("cell", ["batch", "stream"])
def test_imu_kernel_share_reads_the_counters(tmp_path, cell):
    """100 x count vicalib.imu.kernel_factors over vicalib.imu.factors per
    untraced completed call, averaged; a log with factors and no kernel
    factors reads 0, and one without the factor counter (a program that
    counts none) or no log at all reads None."""
    rows = ("span vicalib.lm.iter: n=20 s=2.000000\n"
            "count vicalib.imu.factors: %d\n"
            "count vicalib.imu.kernel_factors: %d\n")
    calls = [
        # the profiled call and a failed call are not read
        _call(tmp_path, "traced", rows % (100, 1), traced=True),
        _call(tmp_path, "a", rows % (400, 400)),
        _call(tmp_path, "b", rows % (400, 300)),
        dict(_call(tmp_path, "failed", rows % (100, 1)), rc=1),
    ]
    read = spec.reader("imu_kernel_pct." + cell)
    assert read({"calls": calls}) == pytest.approx((100.0 + 75.0) / 2)
    cpu = _call(tmp_path, "cpu", "count vicalib.imu.factors: 191\n")
    assert read({"calls": [cpu]}) == 0.0
    bare = {"calls": [_call(tmp_path, "bare",
                            "span vicalib.lm.iter: n=20 s=2.000000\n"),
                      dict(_call(tmp_path, "gone", ""),
                           out=str(tmp_path / "missing"))]}
    assert read(bare) is None
