"""The port's span and counter registry (vicalib_tpu_torch/obs.py): nothing
is recorded outside a recording, no torch profiler call is made while no
profiler runs, and spans, counters and recordings nest.  Spans under a
profiler: tests/test_torch_engine_live.py::test_profile_dir_writes_a_trace."""
import time

import pytest
import torch

from vicalib_tpu_torch import obs


def test_spans_and_counters_record_nest_and_stay_off_the_profiler(
        monkeypatch):
    def no_profiler_call(*a, **k):
        raise AssertionError("record_function called with no profiler")

    for owner, name in ((torch._C._profiler, "_RecordFunctionFast"),
                        (torch.profiler, "record_function"),
                        (torch.autograd.profiler, "record_function")):
        monkeypatch.setattr(owner, name, no_profiler_call)

    # outside a recording: nothing recorded, the span still timed
    with obs.span("vicalib.test.outer") as sp:
        time.sleep(0.002)
    obs.count("vicalib.test.items", 5)
    assert sp.s >= 0.002

    with obs.recording() as rec:
        assert rec.spans == {} and rec.counts == {}
        with obs.span("vicalib.test.outer") as outer:
            for _ in range(3):
                with obs.span("vicalib.test.inner"):
                    obs.count("vicalib.test.items")
            with obs.recording() as inner_rec:
                with obs.span("vicalib.test.inner"):
                    obs.count("vicalib.test.items", 4)
        obs.count("vicalib.test.items", 2)
    assert inner_rec.n("vicalib.test.inner") == 1
    assert inner_rec.count("vicalib.test.items") == 4
    # the inner recording's totals reached the outer one when it closed
    assert rec.n("vicalib.test.outer") == 1
    assert rec.n("vicalib.test.inner") == 4
    assert rec.count("vicalib.test.items") == 3 + 4 + 2
    assert rec.seconds("vicalib.test.outer") == pytest.approx(outer.s)
    assert 0 < rec.seconds("vicalib.test.inner") <= outer.s
    assert rec.n("vicalib.test.absent") == 0
    assert rec.seconds("vicalib.test.absent") == 0.0
    assert rec.rows() == [
        "span vicalib.test.inner: n=4 s=%.6f"
        % rec.seconds("vicalib.test.inner"),
        "count vicalib.test.items: 9",
        "span vicalib.test.outer: n=1 s=%.6f" % outer.s]
    # closed: recording again starts from nothing
    with obs.span("vicalib.test.outer"):
        obs.count("vicalib.test.items")
    assert rec.n("vicalib.test.outer") == 1
    assert obs._current is None

