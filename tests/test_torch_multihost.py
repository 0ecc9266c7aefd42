"""Two processes joined by torch.distributed: the port's multi-process path
on the CPU.

The module fixture starts this file twice as a script (the ``__main__``
block below), ranks 0 and 1, joined over gloo on ``tcp://127.0.0.1``.  Each
worker
1. takes one sharded LM step (one shard per process, ``global_mesh``) on a
   12-frame mono VI problem from the port's simulator, and rank 0 saves it;
2. runs ``cli.main`` with ``-coordinator_address`` on the checked-in
   fixture ``tests/data/vi_smoke`` camera-only (12 mono 400x300 frames,
   5 LM iterations at most), each rank in a directory of its own with
   relative output paths, so a file rank 1 wrote would show.

Tolerances: rank 0's step against one process over the same 2 shards is
exact up to rounding (two partial sums, added in either order) and held at
rtol 1e-12; against the unsharded step as tests/test_dist.py holds JAX's
sharded step (cost 1e-12, trial cost 1e-8, state 1e-9).  The cameras.xml
against the single-process CLI's with tests/test_dist.py's staged
tolerances (pose 1e-5) and intrinsics within 1e-4 px; so is one process
with ``-n_shards 3``.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DATA = os.path.join(HERE, "data", "vi_smoke")
F64 = torch.float64
TIMEOUT_S = 240


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_argv():
    return ["-cam", "file://%s/images/*.pgm" % DATA, "-models", "linear",
            "-nouse_only_when_static", "-nocalibrate_imu", "-max_iters", "5",
            "-output", "cameras.xml", "-output_log_file", "v.log"]


def _vi_problem():
    """The step's problem, state, weights, masks and damping: the same on
    every rank (seeded simulator, CPU)."""
    from vicalib_tpu_torch.io import sim
    from vicalib_tpu_torch.solver import problem as tp
    from vicalib_tpu_torch.solver import stages as tst
    from vicalib_tpu_torch.solver.build import problem_from_sim
    from vicalib_tpu_torch.solver.weights import imu_weights

    cfg = sim.default_mono_config(
        n_frames=12, model="linear", imu=True, imu_rate=100.0,
        gyro_bias=np.array([0.01, -0.02, 0.015]),
        accel_bias=np.array([0.05, 0.02, -0.04]), time_offset=0.004,
        pixel_noise=0.1)
    data, state = problem_from_sim(sim.simulate(cfg, device="cpu"),
                                   use_imu=True, window_slack=0.1,
                                   device="cpu")
    state = tst.initialize_extrinsic_rotation(state, data.imu)
    state = tst.initialize_velocities(state, data.imu)
    state = tst.initialize_gravity(state, data.imu, data.n_frames)
    flags = tp.StageFlags(calibrate_imu=True, inertial_active=True,
                          rotation_only=False, bias_active=True)
    masks = (tp.frame_mask(flags, data.n_frames, F64, "cpu"),
             tp.shared_mask(data.layout, flags, F64, "cpu"))
    return data, state, imu_weights(state, data.imu), masks


def _step(data, state, W, masks, mesh=None):
    """One LM step: unsharded without ``mesh``, else over its shards."""
    from vicalib_tpu_torch.dist import ShardedLMStep
    from vicalib_tpu_torch.solver import lm as tlm

    args = (torch.tensor(1e-4, dtype=F64), torch.tensor(2.0, dtype=F64))
    rest = (*masks, torch.tensor(1.0, dtype=F64), False)
    if mesh is None:
        return tlm._lm_step(data, state, *args, W, *rest, tlm.LMOptions())
    sh = ShardedLMStep(data, mesh=mesh)
    return sh.make_step()(state, *args, sh.sharded_weight(W), *rest)


def _flat(out):
    """The step's state fields and its scalars as one dict of arrays."""
    new, lam, _, cost, trial, acc, gnorm, _ = out
    d = {k: v.numpy() for k, v in new._asdict().items()}
    d.update(lam=lam.numpy(), cost=cost.numpy(), trial=trial.numpy(),
             accept=acc.numpy(), gnorm=gnorm.numpy())
    return d


def _worker(rank, port_step, port_cli, out):
    """One rank: the sharded step, then the multi-process CLI."""
    from vicalib_tpu_torch import cli
    from vicalib_tpu_torch.dist import global_mesh, multihost

    multihost.initialize("127.0.0.1:%d" % port_step, 2, rank, device="cpu")
    try:
        out_step = _step(*_vi_problem(), mesh=global_mesh("cpu"))
    finally:
        multihost.shutdown()
    if rank == 0:
        np.savez(os.path.join(out, "step.npz"), **_flat(out_step))
    run_dir = os.path.join(out, "rank%d" % rank)
    os.makedirs(run_dir)
    os.chdir(run_dir)
    return cli.main(_cli_argv() + [
        "-coordinator_address", "127.0.0.1:%d" % port_cli,
        "-num_processes", "2", "-process_id", str(rank)], device="cpu")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("two_ranks"))
    ports = [str(_free_port()), str(_free_port())]
    # one intra-op thread per process: two processes of tiny ops share the
    # test machine's cores with the other test workers
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    logs = [open(os.path.join(out, "rank%d.log" % r), "w") for r in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), *ports, out],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=REPO)
        for r in (0, 1)]
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    texts = []
    for r, p in enumerate(procs):
        with open(os.path.join(out, "rank%d.log" % r)) as f:
            texts.append(f.read())
        assert p.returncode == 0, "rank %d failed:\n%s" % (r, texts[r])
    return out, texts


def test_two_process_step_matches_single_process(two_ranks):
    from vicalib_tpu_torch.dist import make_mesh

    out, _ = two_ranks
    got = dict(np.load(os.path.join(out, "step.npz")))
    problem = _vi_problem()
    same_shards = _flat(_step(*problem, mesh=make_mesh(2, device="cpu")))
    for k, v in same_shards.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=0,
                                   err_msg=k)
    single = _flat(_step(*problem))
    assert bool(got["accept"]) == bool(single["accept"])
    np.testing.assert_allclose(got["cost"], single["cost"], rtol=1e-12)
    np.testing.assert_allclose(got["trial"], single["trial"], rtol=1e-8)
    for k in problem[1]._fields:
        np.testing.assert_allclose(got[k], single[k], rtol=0, atol=1e-9,
                                   err_msg=k)


def _cli_in(path, extra=()):
    """cli.main on the CPU with ``path`` as the working directory; the
    camera it writes."""
    from vicalib_tpu_torch import cli
    from vicalib_tpu_torch.io.outputs import read_cameras_xml

    cwd, threads = os.getcwd(), torch.get_num_threads()
    os.chdir(path)
    torch.set_num_threads(1)       # as the ranks run (OMP_NUM_THREADS=1)
    try:
        assert cli.main(_cli_argv() + list(extra), device="cpu") == 0
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
    (cam,) = read_cameras_xml(os.path.join(path, "cameras.xml"))
    return cam


@pytest.fixture(scope="module")
def single_cli(tmp_path_factory):
    return _cli_in(str(tmp_path_factory.mktemp("single")))


def _same_calibration(cam, ref):
    np.testing.assert_allclose(cam["params"], ref["params"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(cam["T_wc"], ref["T_wc"], rtol=0, atol=1e-5)


def test_two_process_cli_writes_one_calibration(two_ranks, single_cli):
    from vicalib_tpu_torch.io.outputs import read_cameras_xml

    out, texts = two_ranks
    assert sorted(os.listdir(os.path.join(out, "rank0"))) == \
        ["cameras.xml", "v.log"]
    assert os.listdir(os.path.join(out, "rank1")) == []
    assert "process 1 wrote nothing" in texts[1]
    assert "gloo collectives" in texts[0] and "gloo collectives" in texts[1]
    (two,) = read_cameras_xml(os.path.join(out, "rank0", "cameras.xml"))
    _same_calibration(two, single_cli)


def test_cli_n_shards_in_one_process(single_cli, tmp_path, caplog):
    with caplog.at_level("INFO", logger="vicalib_tpu_torch.dist"):
        cam = _cli_in(str(tmp_path), ["-n_shards", "3"])
    assert "process 0/1 holds shards [0, 1, 2] of 3 on ['cpu', 'cpu', " \
        "'cpu']" in caplog.text
    _same_calibration(cam, single_cli)


def test_backend_rule():
    from vicalib_tpu_torch.dist.multihost import choose_backend

    own = [("h0", 0), ("h0", 1), ("h1", 0)]
    assert choose_backend("cuda", own) == "nccl"
    assert choose_backend("cuda", [("h0", 0), ("h0", 0)]) == "gloo"
    assert choose_backend("cpu", own) == "gloo"


def test_mesh_placement_and_global_arrays():
    from vicalib_tpu_torch.dist import (SHARD_AXIS, global_replicated,
                                        global_shard, make_mesh)

    mesh = make_mesh(3, device="cpu")
    assert SHARD_AXIS == "shard"
    assert (mesh.n_shards, mesh.shard_ids, mesh.world_size) == \
        (3, (0, 1, 2), 1)
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert make_mesh(device="cpu").n_shards == 1
    a = np.arange(12.0).reshape(3, 4)
    rows = global_shard(mesh, a)
    for i, r in enumerate(rows):
        np.testing.assert_array_equal(r.numpy(), a[i])
    with pytest.raises(ValueError):
        global_shard(mesh, a[:2])
    np.testing.assert_array_equal(global_replicated(mesh, a).numpy(), a)


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                     sys.argv[4]))
