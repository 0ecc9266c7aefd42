"""Fast CPU tests of the harness: its data files, the frozen simulator, the
reference's reading of outputs, the plain reference's model of the rig,
the readers, the trace reduction, the roofline count and the import
check."""
import dataclasses
import os
import re
import types

import numpy as np
import pytest
import torch

from harness import inputs, purity, reference, roofline, sim, spec, trace
from plainref import lm

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark_json()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def _config(name):
    return spec._load_json(os.path.join(spec.BENCH_DIR, "configs",
                                        name + ".json"))


def test_benchmark_json_follows_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        # every cell that reports it reports the metric it moves
        moved = e2e[m["moves"]].get("workloads", WORKLOADS)
        assert set(m["workloads"]) <= set(moved)
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        path = os.path.join(spec.ROOT, c["file"])
        assert c["file"].startswith("benchmark/configs/")
        assert sorted(c["reduced"]) == sorted(
            spec._load_json(path)["reduced"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_load(workload):
    cell = spec.load_cell(workload)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer and cell.limits
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))
    sim.rig_from_config(cell.config)


def test_renderer_is_deterministic_in_the_seed(tmp_path):
    conf = _config("vi_sim")
    a, pa = inputs.write_rig(conf, 2 ** 31 + 11, str(tmp_path / "a"), "cpu",
                             n_frames=2)
    b, pb = inputs.write_rig(conf, 2 ** 31 + 11, str(tmp_path / "b"), "cpu",
                             n_frames=2)
    c, pc = inputs.write_rig(conf, 5, str(tmp_path / "c"), "cpu",
                             n_frames=2)

    def read(paths, name):
        with open(os.path.join(paths["cams"][1], name), "rb") as f:
            return f.read()

    assert read(pa, "f00001.pgm") == read(pb, "f00001.pgm")
    assert read(pa, "f00001.pgm") != read(pc, "f00001.pgm")
    np.testing.assert_array_equal(a.gyro, b.gyro)
    assert not np.array_equal(a.gyro, c.gyro)
    # the seed draws noise only: the trajectory and frames' timing stay
    np.testing.assert_array_equal(a.q_wk, c.q_wk)
    np.testing.assert_array_equal(a.frame_times, c.frame_times)


def test_renderer_draws_a_batch_of_frames_as_one_at_a_time():
    rig = dataclasses.replace(sim.rig_from_config(_config("euroc"), 3),
                              image_noise=0.0)
    truth = sim.simulate(rig, 2 ** 31 + 5, "cpu")
    gen = torch.Generator()
    one = sim.render(truth, 1, gen, "cpu", pixels_per_launch=1)
    batch = sim.render(truth, 1, gen, "cpu")
    np.testing.assert_array_equal(one, batch)
    assert one.shape == (3, 480, 752) and one.min() < 64 < one.max()


def test_roofline_counts_unpadded_frames():
    vi = _config("vi_sim")["rig"]["cameras"]
    eu = _config("euroc")["rig"]["cameras"]
    assert roofline.threshold_and_label_bytes((32, 600, 896), vi) == \
        32 * 600 * 800 * 5
    assert roofline.threshold_and_label_bytes((1, 480, 768), eu) == \
        480 * 752 * 5
    with pytest.raises(ValueError):
        roofline.threshold_and_label_bytes((32, 592, 896), vi)


def test_import_check_compares_whole_top_level_names():
    assert purity.forbidden_modules(
        ["vicalib_tpu_torch", "vicalib_tpu_torch.cli", "jaxtyping",
         "numpy"]) == []
    assert purity.forbidden_modules(
        ["vicalib_tpu.engine", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "vicalib_tpu"]


# ----------------------------------------------------------- reference
def _write_outputs(out, truth, d_fx=0.0):
    """cameras.xml, the result log and poses.txt as the program writes
    them, holding the truth (camera 0's fx moved by ``d_fx``)."""
    rig = truth.rig
    cams = []
    B = np.eye(4)
    B[:3, :3] = sim.RDF_ROBOTICS
    for i, c in enumerate(rig.cameras):
        M = np.eye(4)
        M[:3, :3] = reference.quat_to_matrix(c.q_ck)
        M[:3, 3] = c.t_ck
        T_wc = np.linalg.inv(M) @ np.linalg.inv(B)
        p = c.params.copy()
        p[0] += d_fx if i == 0 else 0.0
        cams.append(
            "<camera><camera_model type='x'><params>[ %s ]</params>"
            "</camera_model><pose><T_wc>[ %s ]</T_wc></pose></camera>" % (
                ", ".join("%.12g" % v for v in p),
                "; ".join(", ".join("%.12g" % v for v in r)
                          for r in T_wc[:3])))
    with open(os.path.join(out, "cameras.xml"), "w") as f:
        f.write("<?xml version='1.0'?><rig>%s</rig>" % "".join(cams))

    def vec(v):
        return " ".join("%.17g" % x for x in v)

    with open(os.path.join(out, "vicalibrator.log"), "w") as f:
        f.write("bw_ba= [%s]\nG= [%s]\nts= %.17g\n"
                "stage visual: iters=5 cost=1e-2 wall=1.00s\n"
                "stage inertial-full: iters=7 cost=1e-2 wall=1.00s\n" % (
                    vec(np.r_[rig.gyro_bias, rig.accel_bias]),
                    vec(rig.g_dir), rig.time_offset))
    rows = []
    for q, t in zip(truth.q_wk, truth.t_wk):
        R = reference.quat_to_matrix(q)
        rows.append([*t, np.arctan2(R[2, 1], R[2, 2]), -np.arcsin(R[2, 0]),
                     np.arctan2(R[1, 0], R[0, 0])])
    np.savetxt(os.path.join(out, "poses.txt"), np.array(rows), fmt="%f",
               delimiter="\t")


@pytest.mark.parametrize("config", ["vi_sim", "euroc"])
def test_reference_reads_the_programs_outputs(tmp_path, config):
    rig = sim.rig_from_config(_config(config), n_frames=6)
    truth = sim.simulate(rig, 3, "cpu")
    ref = reference.truth_outputs(truth)
    _write_outputs(str(tmp_path), truth)
    nums = reference.compare(reference.read_outputs(str(tmp_path)), ref, rig)
    assert set(nums) == set(reference.NUMBERS)
    assert nums["missing_poses"] == 0
    for k, v in nums.items():
        assert v < 2e-6, (k, v)      # poses.txt keeps 6 decimals
    _write_outputs(str(tmp_path), truth, d_fx=1.0)
    moved = reference.compare(reference.read_outputs(str(tmp_path)), ref,
                              rig)
    # fx + 1 moves the frame's left edge by about cx / fx pixels
    c0 = rig.cameras[0]
    assert moved["intr_px"] == pytest.approx(c0.params[2] / c0.params[0],
                                             rel=0.1)
    os.remove(str(tmp_path / "poses.txt"))
    assert reference.compare(reference.read_outputs(str(tmp_path)), ref,
                             rig)["missing_poses"] == 6
    os.remove(str(tmp_path / "cameras.xml"))
    assert reference.read_outputs(str(tmp_path)) is None
    assert reference.compare(None, ref, rig)["intr_px"] == float("inf")
    ok, checks = reference.judge(moved, {"intr_px": 0.5, "extr": 1e-3})
    assert not ok and checks["intr_px"]["limit"] == 0.5


def test_published_estimates_are_paired_by_chunk():
    pub = [{"ts": 0.004}] * 3
    assert reference.compare_published(pub, 3) == {"missing_chunks": 0}
    assert reference.compare_published(pub[:2], 3)["missing_chunks"] == 1
    assert reference.compare_published(pub, None)["missing_chunks"] == \
        float("inf")


# ------------------------------------------------------- plain reference
def test_plain_rotations():
    w = torch.tensor([[0.3, -0.2, 0.1], [1e-5, 2e-5, -1e-5], [0.0] * 3,
                      [2.0, 1.0, -0.5]], dtype=torch.float64)
    R = lm.exp_so3(w)
    eye = torch.eye(3, dtype=torch.float64)
    torch.testing.assert_close(R @ R.transpose(1, 2), eye.expand(4, 3, 3),
                               atol=1e-15, rtol=0)
    torch.testing.assert_close(lm.log_so3(R), w, atol=1e-14, rtol=0)
    # the inverse of the left Jacobian I + (1-cos)/t^2 W + (t-sin)/t^3 W^2
    th = torch.linalg.norm(w, dim=1)[:, None, None].clamp(min=1e-300)
    W = lm.hat(w)
    J = (eye + (1 - torch.cos(th)) / th ** 2 * W
         + (th - torch.sin(th)) / th ** 3 * W @ W)
    torch.testing.assert_close(lm.jl_inv(w[[0, 1, 3]]) @ J[[0, 1, 3]],
                               eye.expand(3, 3, 3), atol=1e-12, rtol=0)
    g = torch.tensor([0.15, -0.1], dtype=torch.float64)
    torch.testing.assert_close(lm.gravity(g), sim.gravity(g))


@pytest.mark.parametrize("config", ["vi_sim", "euroc"])
def test_plain_residuals_vanish_on_noiseless_data(config):
    """The reference's models of the camera and the IMU against the
    simulator's: at the truth its residuals of noiseless data are what the
    linear interpolation of the IMU samples leaves, and a time offset 2 ms
    off, or a gyro bias 3e-3 rad/s off, stands far out of that."""
    rig = dataclasses.replace(sim.rig_from_config(_config(config), 8),
                              gyro_noise=0.0, accel_noise=0.0)
    truth = sim.simulate(rig, 1, "cpu")
    F = len(truth.frame_times)
    st = reference._initial_state(truth, np.arange(F), "cpu")

    def imu(st):
        win = lm.cut_windows(truth.imu_times, truth.gyro, truth.accel,
                             truth.frame_times, float(st.offset), "cpu")
        return lm.imu_residuals(st, win).abs().max()

    sound = imu(st)
    assert sound < 2e-5
    assert imu(dataclasses.replace(st, offset=st.offset + 2e-3)) > 30 * sound
    assert imu(dataclasses.replace(st, bias=st.bias + torch.tensor(
        [3e-3, 0, 0, 0, 0, 0], dtype=torch.float64))) > 30 * sound
    pts = torch.as_tensor(rig.target.circles_3d(), dtype=torch.float64)
    pix = []
    for c in rig.cameras:
        p_k = sim.se3_apply(sim.se3_inv((
            torch.as_tensor(truth.q_wk)[:, None],
            torch.as_tensor(truth.t_wk)[:, None])), pts[None])
        p_c = sim.se3_apply((torch.as_tensor(c.q_ck),
                             torch.as_tensor(c.t_ck)), p_k)
        pix.append(sim.project(c.model, p_c, torch.as_tensor(c.params)))
    prob = lm.Problem(models=[c.model for c in rig.cameras], p_w=pts,
                      pixels=torch.stack(pix),
                      valid=torch.as_tensor(truth.visible,
                                            dtype=torch.float64),
                      frame_t=truth.frame_times, imu_t=truth.imu_times,
                      imu_g=truth.gyro, imu_a=truth.accel)
    assert truth.visible.sum() > 0.9 * truth.visible.size
    assert lm.reproj_residuals(prob, st).abs().max() < 1e-9


# ------------------------------------------------------------- readers
def _record(trace_rec=None):
    """A traced run's record as the runner builds it: two calibrations
    and, for the stream readers, their chunks."""
    calls = [
        # the first call ran under the profiler: no timer reads it
        {"rc": 0, "wall_s": 50.0, "traced": True,
         "stages": [("visual", 9)], "timings": {"solve": 40.0},
         "chunks": [{"iterations": 99}]},
        {"rc": 0, "wall_s": 5.0, "traced": False, "stages": [("visual", 5), ("full", 15)],
         "timings": {"read": 0.1, "detect": 0.3, "build": 0.05,
                     "solve": 4.0},
         "chunks": [{"iterations": 27}, {"iterations": 6}]},
        {"rc": 0, "wall_s": 6.0, "traced": False, "stages": [("visual", 5), ("full", 17)],
         "timings": {"read": 0.2, "detect": 0.3, "build": 0.05,
                     "solve": 5.0},
         "chunks": [{"iterations": 25}, {"iterations": 6}]},
    ]
    return {"calls": calls, "window_s": 11.0, "trace": trace_rec,
            "kernel_bytes": 2 * 32 * 600 * 800 * 5,
            "peaks": roofline.PEAKS["NVIDIA H100 80GB HBM3"]}


def test_readers_parse_a_recorded_run():
    t = {"window_s": 10.0, "busy_s": 0.4, "kernel_device_s": 0.8e-3}
    rec = _record(t)

    def read(name):
        return spec.reader(name)(rec)

    assert read("read_s.batch") == pytest.approx(0.15)
    assert read("solve_s.batch") == pytest.approx(4.5)
    assert read("engine_other_s.batch") == pytest.approx(
        (5.0 - 4.45 + 6.0 - 5.55) / 2)
    assert read("lm_iters.batch") == 21
    assert read("lm_iters_per_chunk.stream") == 16
    assert read("device_idle_pct.batch") == pytest.approx(96.0)
    assert read("kernel_roofline_pct.batch") == pytest.approx(
        100 * 2 * 32 * 600 * 800 * 5 / 3.35e12 / 0.8e-3)
    # nothing to read: the metric is left out, never 0
    bare = _record(None)
    assert spec.reader("device_idle_pct.stream")(bare) is None
    assert spec.reader("kernel_roofline_pct.batch")(bare) is None


class _Ev:
    def __init__(self, act, name, s, e, corr=0, link=0):
        self.a, self.n, self.s, self.e, self.c, self.l = (act, name, s, e,
                                                          corr, link)

    def activity_type(self):
        return self.a

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s

    def correlation_id(self):
        return self.c

    def linked_correlation_id(self):
        return self.l


class _OldEv(_Ev):
    """An event of a build whose events carry no activity type."""
    activity_type = None

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA
                if self.a in ("kernel", "gpu_memcpy", "gpu_memset")
                else torch.autograd.DeviceType.CPU)


@pytest.mark.parametrize("event", [_Ev, _OldEv])
def test_trace_reduction_of_recorded_events(event):
    evs = [
        event("user_annotation", trace.CALL_SPAN, 0, 10_000),
        event("user_annotation", "bench.solve", 5_000, 10_000),
        event("cpu_op", "aten::add", 6_000, 9_000),
        event("user_annotation", trace.KERNEL_SPAN, 1_000, 2_000),
        event("cuda_runtime", "cudaLaunchKernel", 1_100, 1_200, corr=7),
        event("cuda_runtime", "cudaLaunchKernel", 3_000, 3_100, corr=8),
        event("kernel", "threshold_tile", 2_500, 2_900, corr=7),
        event("kernel", "elementwise", 2_800, 3_500, corr=8),
        event("gpu_memcpy", "Memcpy DtoH", 9_500, 9_700, corr=9),
    ]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    r = trace.reduce(prof)
    assert r["window_s"] == pytest.approx(10e-6)
    assert r["busy_s"] == pytest.approx((1_000 + 200) * 1e-9)
    assert r["kernel_device_s"] == pytest.approx(400e-9)
    assert r["kernel_launches"] == 1
    assert r["device_ops"][0] == ["elementwise", pytest.approx(700e-9)]
    # the longest gap, 3.5-9.5 us, is in the solve, inside aten::add
    assert r["idle_gaps"][0] == ["bench.solve / aten::add",
                                 pytest.approx(6_000e-9)]
    assert r["idle_gaps"][1][0] == "bench.call / (host, no op)"
