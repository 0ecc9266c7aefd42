"""The readers of the LM loop's CUDA graph replay share
(metrics/lm_graph_replay_pct.*.py) on recorded result logs: with the
program's ``count vicalib.lm.graph_replay`` row, and without it."""
import pytest

from harness import spec


def _call(tmp_path, name, text, traced=False):
    out = tmp_path / name
    out.mkdir()
    (out / "vicalibrator.log").write_text(text)
    return {"out": str(out), "rc": 0, "traced": traced, "wall_s": 5.0,
            "timings": {"solve": 4.0}, "stages": [], "chunks": []}


@pytest.mark.parametrize("cell", ["batch", "stream"])
def test_graph_replay_share_reads_the_counter(tmp_path, cell):
    """100 x count vicalib.lm.graph_replay over n(vicalib.lm.iter) per
    untraced completed call, averaged; a log without the counter (a
    program that replays nothing) or no log at all reads None."""
    iters = "span vicalib.lm.iter: n=%d s=2.000000\n"
    replays = "count vicalib.lm.graph_replay: %d\n"
    calls = [
        # the profiled call and a failed call are not read
        _call(tmp_path, "traced", iters % 20 + replays % 1, traced=True),
        _call(tmp_path, "a", iters % 20 + replays % 18),
        _call(tmp_path, "b", iters % 10 + replays % 8),
        dict(_call(tmp_path, "failed", iters % 20 + replays % 1), rc=1),
    ]
    read = spec.reader("lm_graph_replay_pct." + cell)
    assert read({"calls": calls}) == pytest.approx((90.0 + 80.0) / 2)
    bare = {"calls": [_call(tmp_path, "bare", iters % 20),
                      dict(_call(tmp_path, "gone", ""),
                           out=str(tmp_path / "missing"))]}
    assert read(bare) is None
