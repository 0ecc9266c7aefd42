"""The check that decides ``correct`` has to fail the control and each fault
a calibration cell can have.  These tests drive a whole run of the
vi_sim.batch cell on the CPU at 24 frames a camera (the harness's look for a
card skipped): once as it is, where the program and the plain reference
(plainref/: its own detections and one dense float64 Levenberg-Marquardt)
reach the same minimum, then with the timed path broken underneath, and
with the control in the program's place.  Each broken run has to come out not
correct, with the number that catches it over its limit and far (ten
times) beyond the sound run's.

The faults: a step that returns its state unchanged (every LM step keeps
the state it was given); half of the batch left out (every second frame's
detections dropped, the solve run on the rest); an answer altered where it
is produced (camera 0's fx written one pixel off into cameras.xml).  The
cell runs on one card, so no exchange between cards can be left out.

The control is the program's own float32 solve (``-dtype float32``) where
the configuration states float64.  The card-sized control is
``test_control_on_the_card``, marked ``chip``.
"""
import pytest

from harness import runner, spec

N_FRAMES = 24
SEED = 2 ** 31 + 77


def _run(dtype=None):
    cell = spec.load_cell("vi_sim.batch")
    res, _ = runner.run_cell(cell, SEED, 0.0, False, "cpu",
                             n_frames=N_FRAMES, dtype=dtype, warm=False)
    return res


def _numbers(res):
    return {k: c["value"] for k, c in res["checks"].items()}


@pytest.fixture(scope="module")
def sound():
    res = _run()
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == 1
    return _numbers(res)


def test_sound_run_agrees_with_the_reference(sound):
    cell = spec.load_cell("vi_sim.batch")
    assert all(v <= cell.limits[k] for k, v in sound.items())
    assert sound["missing_poses"] == 0


def _keep_state(orig):
    def step(data, state, *a, **k):
        return (state,) + tuple(orig(data, state, *a, **k)[1:])
    return step


def _drop_half(orig):
    def detect(images, *a, **k):
        pixels, visible, rows = orig(images, *a, **k)
        visible[1::2] = False
        return pixels, visible, rows
    return detect


def _alter_fx(orig):
    def write(path, names, intrinsics, *a, **k):
        intrinsics = [p.copy() for p in intrinsics]
        intrinsics[0][0] += 1.0
        return orig(path, names, intrinsics, *a, **k)
    return write


FAULTS = {
    "state_unchanged": ("vicalib_tpu_torch.solver.lm", "_lm_step",
                        _keep_state, "intr_px"),
    "half_the_batch": ("vicalib_tpu_torch.engine", "_detect_all",
                       _drop_half, "missing_poses"),
    "answer_altered": ("vicalib_tpu_torch.io.outputs", "write_cameras_xml",
                       _alter_fx, "intr_px"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_the_run_incorrect(fault, sound, monkeypatch):
    import importlib
    mod_name, attr, wrap, catches = FAULTS[fault]
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    res = _run()
    assert res["correct"] is False
    got = _numbers(res)[catches]
    assert got > 10 * sound[catches]
    assert got > res["checks"][catches]["limit"]


def test_control_float32_is_incorrect(sound):
    res = _run(dtype="float32")
    assert res["correct"] is False
    got = _numbers(res)
    assert any(v > res["checks"][k]["limit"] and v >= 3 * sound[k]
               for k, v in got.items())


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["vi_sim.batch", "vi_sim.stream"])
def test_control_on_the_card(cuda, workload):
    """The control at the cell's own size on three seeds: never correct."""
    import control
    rows = control.readings(workload, [1, 2, 3], "float32", cuda)
    assert [ok for _, ok, _ in rows] == [False] * 3
