"""The LM loop's graph path on the CPU: its schedule and buffers, and the
capture safety of the bodies it replays.

On a CUDA state ``LMSolver`` keeps one ``_LoopState`` for all its stages
and runs the step and the IMU weight refresh through ``_Graphs``: a
body's first run in the thread is eager; each solver captures it at its
first run after that and replays it from then on.  Here a stand-in
graph whose replay calls the body drives that schedule on the CPU, and the
staged VI schedule through it must equal the eager ``fused_solve`` bit for
bit (the same bodies on the same float64 numbers).  The bodies must also
build no tensor from host data and read nothing back to the host, which a
CUDA graph cannot capture; a dispatch mode records such ops.  On the card
``chip_smoke.py`` holds the real graphs to the eager loop.

The problem is the VI solver tests' 12-frame mono sequence (100 Hz IMU,
biases, 4 ms offset, 0.1 px noise, 0.1 s slack), simulated by the port,
with a 1e-4 function tolerance as there and at most 10 iterations a
stage.
"""
import contextlib
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vicalib_tpu_torch import obs
from vicalib_tpu_torch.io import sim as tsim
from vicalib_tpu_torch.solver import lm as tlm
from vicalib_tpu_torch.solver import problem as tp
from vicalib_tpu_torch.solver import stages as tst
from vicalib_tpu_torch.solver.build import problem_from_sim

F64 = torch.float64
# at most 10 iterations a stage: the visual and inertial-rotation stages
# stop on the stop flag, the inertial-full stages at the cap
OPTIONS = tlm.LMOptions(function_tolerance=1e-4, max_iters=10)
SIGMAS = (tst.IMU_GYRO_SIGMA, tst.IMU_ACCEL_SIGMA)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small float64 ops: one torch thread is many times faster than
    several on a machine that other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def vi():
    cfg = tsim.default_mono_config(
        n_frames=12, model="linear", imu=True, imu_rate=100.0,
        gyro_bias=np.array([0.01, -0.02, 0.015]),
        accel_bias=np.array([0.05, 0.02, -0.04]), time_offset=0.004,
        pixel_noise=0.1)
    data, state = problem_from_sim(tsim.simulate(cfg, device="cpu"),
                                   use_imu=True, window_slack=0.1,
                                   device="cpu")
    return data, state


class _PlainGraphs(tlm._Graphs):
    """``_Graphs`` whose graph replays by calling the body: the graph
    path's schedule, counters and buffers without a card."""

    def __init__(self, device):
        self.device = device
        self.graphs = {}

    @contextlib.contextmanager
    def side_stream(self):
        yield

    def _capture(self, body):
        return types.SimpleNamespace(replay=body)


def _staged(data, state, monkeypatch, graphed, thread=None):
    """run_staged with every step's loop values and every stage's info
    vector recorded; ``graphed`` drives it through the graph path, with
    ``thread`` as the graph path's state of the thread."""
    steps, infos = [], []
    step_body, info_vec = tlm._step_body, tlm._info_vec

    def step(data, loop, rotation_only, options):
        step_body(data, loop, rotation_only, options)
        steps.append([x.clone() for x in (*loop.state, loop.lam, loop.nu,
                                          loop.best, loop.stall,
                                          loop.converged)])

    def info(*a):
        out = info_vec(*a)
        infos.append(out.clone())
        return out

    with monkeypatch.context() as m:
        m.setattr(tlm, "_step_body", step)
        m.setattr(tlm, "_info_vec", info)
        if graphed:
            m.setattr(tlm, "_graph_path", lambda data, state: True)
            m.setattr(tlm, "_Graphs", _PlainGraphs)
            m.setattr(tlm, "_THREAD", thread)
        flags = tp.StageFlags(calibrate_imu=True, optimize_time_offset=True)
        with obs.recording() as rec:
            res = tst.run_staged(state, data, flags, OPTIONS)
    return res, steps, infos, rec


def test_graph_path_equals_eager_solve_bit_for_bit(vi, monkeypatch):
    """All four stages on one solver's loop state through the graph
    schedule, in a fresh thread and again once its bodies have run: the
    same iterations per stage, and every step's state, lambda, nu, best
    cost, stall count and stop flag, every stage's info vector and the
    final state exactly equal to the eager fused_solve."""
    data, state = vi
    eager, steps_e, infos_e, rec_e = _staged(data, state, monkeypatch,
                                             graphed=False)
    assert [r[0] for r in eager.stages_run] == [
        "visual", "inertial-rotation", "inertial-full",
        "inertial-full+scale"]
    assert len(steps_e) == eager.total_iterations
    assert len(infos_e) == 4
    assert rec_e.count("vicalib.lm.graph_capture") == 0
    assert rec_e.count("vicalib.lm.graph_replay") == 0
    thread = tlm._ThreadState()
    # the schedule: two step keys (rotation_only True in the visual and
    # inertial-rotation stages, False after) and the weight refresh, each
    # captured once; in a fresh thread each key's first run is eager
    for eager_runs in (2, 0):
        graph, steps_g, infos_g, rec_g = _staged(data, state, monkeypatch,
                                                 graphed=True,
                                                 thread=thread)
        assert [r[:3] for r in graph.stages_run] == \
            [r[:3] for r in eager.stages_run]
        assert len(steps_g) == len(steps_e)
        for i, (a, b) in enumerate(zip(steps_g, steps_e)):
            for x, y in zip(a, b):
                assert torch.equal(x, y), "step %d" % i
        assert len(infos_g) == len(infos_e)
        for a, b in zip(infos_g, infos_e):
            assert torch.equal(a, b)
        for name, x, y in zip(tp.CalibState._fields, graph.state,
                              eager.state):
            assert torch.equal(x, y), name
        assert rec_g.n("vicalib.lm.iter") == rec_e.n("vicalib.lm.iter")
        assert rec_g.count("vicalib.lm.graph_capture") == 3
        assert rec_g.count("vicalib.lm.graph_replay") == \
            rec_g.n("vicalib.lm.iter") - eager_runs
        assert rec_g.n("vicalib.lm.replay") > rec_g.count(
            "vicalib.lm.graph_replay")
        assert len(thread.warm) == 3


_HOST = {"aten::lift_fresh", "aten::_local_scalar_dense"}


class _HostDataOps(TorchDispatchMode):
    """Records the ops that build a tensor from host data or read one back
    to the host, and copies across devices."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if name in _HOST:
            self.found.append(name)
        elif name == "aten::_to_copy" and "device" in kwargs and \
                torch.device(kwargs["device"]) != args[0].device:
            self.found.append("%s %s->%s" % (name, args[0].device,
                                             kwargs["device"]))
        elif name == "aten::copy_" and args[0].device != args[1].device:
            self.found.append("%s %s->%s" % (name, args[1].device,
                                             args[0].device))
        return func(*args, **kwargs)


@pytest.mark.parametrize("body", ["step_rotation_only", "step_full",
                                  "weights"])
def test_bodies_take_no_host_data(vi, body):
    """The bodies a graph captures: no tensor from host data (a constant
    upload, which the card runs as a synchronising copy), no host read
    (item, bool), no copy between devices."""
    data, state = vi
    ft = tp.StageFlags(calibrate_imu=True, inertial_active=True,
                       rotation_only=body == "step_rotation_only",
                       bias_active=True)
    fmask = tp.frame_mask(ft, data.n_frames, F64, "cpu")
    smask = tp.shared_mask(data.layout, ft, F64, "cpu")
    seed = tlm.seed_weights(data.imu.start.shape[0], F64, "cpu")
    loop = tlm._LoopState(state, seed, fmask, smask, torch.ones((), dtype=F64))
    loop.start(state, seed, fmask, smask, torch.ones((), dtype=F64), OPTIONS)
    before = [x.clone() for x in (*loop.state, loop.W, loop.lam)]
    with _HostDataOps() as mode:
        if body == "weights":
            tlm._weights_body(data, loop, SIGMAS)
        else:
            tlm._step_body(data, loop, body == "step_rotation_only", OPTIONS)
    assert mode.found == []
    # the body wrote its results into the loop's tensors
    after = [*loop.state, loop.W, loop.lam]
    assert any(not torch.equal(a, b) for a, b in zip(after, before))
