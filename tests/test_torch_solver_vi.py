"""Port parity: the visual-inertial solver pieces (torch vs JAX).

One 12-frame mono VI sequence from the JAX simulator (100 Hz IMU, gyro and
accel biases, 4 ms time offset, 0.1 px pixel noise, 0.1 s window slack) is
built into a problem by the JAX package; the problem and every state go to
the port through ``convert`` (numpy dicts keyed by the JAX field names).
Float64 throughout; the JAX side runs under ``jax.jit`` as the JAX package
runs it (each jitted function is made once: XLA compiles dominate this
file's time).
Tolerances, relative to the largest entry of each compared array:
- IMU residuals and Jacobians 1e-9 (two reverse-mode autodiff systems on
  the same arithmetic, summed in other orders);
- whitening weights 1e-8 (a Cholesky and a triangular inverse of 9x9
  systems with condition numbers up to ~1e4 after scaling);
- the assembled system 1e-9; the initializers 1e-10; one LM step as the
  camera-only parity test holds it (test_torch_solver.py).
The sharded solver (dist/) on the same problem: the shards array for array
equal to JAX's; one sharded step at 1, 2 and 3 shards against JAX's
single-device step as tests/test_dist.py holds JAX's own (cost 1e-12,
trial cost 1e-8, state 1e-9); the sharded staged schedule against JAX's
staged result with that file's tolerances (sums in another order can move
a discrete candidate choice and so the iterate path, not the converged
answer).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicalib_tpu.io import sim as jsim
from vicalib_tpu.dist import sharded as jsh
from vicalib_tpu.solver import lm as jlm
from vicalib_tpu.solver import problem as jp
from vicalib_tpu.solver import stages as jst
from vicalib_tpu.solver import weights as jw
from vicalib_tpu.solver.build import problem_from_sim as j_from_sim
from vicalib_tpu.solver.build import refine_offset_guess as j_refine
from vicalib_tpu.solver.residuals import ImuFactors as JImu
from vicalib_tpu.solver.residuals import imu_residuals_and_jacobians as j_rj
from vicalib_tpu_torch import convert
from vicalib_tpu_torch.dist import ShardedLMStep, make_mesh
from vicalib_tpu_torch.dist import sharded as tsh
from vicalib_tpu_torch.solver import lm as tlm
from vicalib_tpu_torch.solver import problem as tp
from vicalib_tpu_torch.solver import stages as tst
from vicalib_tpu_torch.solver import weights as tw
from vicalib_tpu_torch.solver.build import problem_from_sim as t_from_sim
from vicalib_tpu_torch.solver.build import refine_offset_guess as t_refine
from vicalib_tpu_torch.solver.residuals import \
    imu_residuals_and_jacobians as t_rj

ja = importlib.import_module("vicalib_tpu.solver.assemble")
ta = importlib.import_module("vicalib_tpu_torch.solver.assemble")
F64 = torch.float64
J_WEIGHTS = jax.jit(jw.imu_weights)
J_ASSEMBLE = jax.jit(ja.assemble)
J_COSTS = jax.jit(ja.robust_costs)
J_RES_JAC = jax.jit(j_rj)


def _rel_close(actual, desired, rtol):
    desired = np.asarray(desired)
    scale = max(float(np.max(np.abs(desired))), 1e-300)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0,
                               atol=rtol * scale)


def _imu_dict(imu):
    return {f.name: (np.asarray(getattr(imu, f.name))
                     if f.name not in ("consecutive", "slack")
                     else getattr(imu, f.name))
            for f in dataclasses.fields(imu)}


def _problem_dict(data):
    return {"model_names": list(data.layout.model_names),
            "n_frames": data.n_frames,
            "obs": [{"frame_idx": np.asarray(o.frame_idx),
                     "p_w": np.asarray(o.p_w), "p_c": np.asarray(o.p_c),
                     "valid": np.asarray(o.valid),
                     "points_per_frame": o.points_per_frame}
                    for o in data.obs],
            "imu": None if data.imu is None else _imu_dict(data.imu)}


def _to_t(state_j):
    return convert.state_from_numpy(
        {k: np.asarray(v) for k, v in state_j._asdict().items()}, "cpu")


def _states_close(st, sj, atol):
    for name, a, b in zip(sj._fields, sj, st):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=atol, err_msg=name)


def _flags(**kw):
    return (jp.StageFlags(calibrate_imu=True, **kw),
            tp.StageFlags(calibrate_imu=True, **kw))


def _masks(data_j, data_t, fj, ft):
    return ((jp.frame_mask(fj, data_j.n_frames),
             jp.shared_mask(data_j.layout, fj)),
            (tp.frame_mask(ft, data_t.n_frames, F64, "cpu"),
             tp.shared_mask(data_t.layout, ft, F64, "cpu")))


@pytest.fixture(scope="module")
def vi():
    cfg = jsim.default_mono_config(
        n_frames=12, model="linear", imu=True, imu_rate=100.0,
        gyro_bias=np.array([0.01, -0.02, 0.015]),
        accel_bias=np.array([0.05, 0.02, -0.04]), time_offset=0.004,
        pixel_noise=0.1)
    sim_data = jsim.simulate(cfg)
    data_j, state0_j = j_from_sim(sim_data, use_imu=True, window_slack=0.1)
    data_t = convert.problem_from_numpy(_problem_dict(data_j), "cpu")
    # a state the VI stages would see: the JAX initializers applied to the
    # PnP-seeded frames, then small perturbations everywhere
    s = jst.initialize_extrinsic_rotation(state0_j, data_j.imu)
    s = jst.initialize_velocities(s, data_j.imu)
    s = jst.initialize_gravity(s, data_j.imu, data_j.n_frames)
    rng = np.random.default_rng(7)
    s = s._replace(scales=s.scales + rng.normal(size=6) * 1e-3,
                   v_w=s.v_w + rng.normal(size=s.v_w.shape) * 1e-3,
                   time_offset=s.time_offset + 0.003)
    return dict(cfg=cfg, sim=sim_data, data_j=data_j, data_t=data_t,
                state0_j=state0_j, state_j=s, state_t=_to_t(s))


def test_problem_from_sim_matches_jax(vi):
    """Windows are host numpy (exactly equal); the PnP-seeded poses agree
    to the camera-only parity test's 1e-9."""
    data_t, state_t = t_from_sim(vi["sim"], use_imu=True, window_slack=0.1,
                                 device="cpu")
    imu_j, imu_t = vi["data_j"].imu, data_t.imu
    for f in dataclasses.fields(imu_j):
        a, b = getattr(imu_j, f.name), getattr(imu_t, f.name)
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            assert a == b
    _states_close(state_t, vi["state0_j"], 1e-9)
    # the raw-stream offset refinement is a host copy: identical output
    q = np.asarray(vi["state0_j"].q_wk)
    sd = vi["sim"]
    for guess in (0.0, 0.2):
        assert t_refine(sd.frame_times, q, sd.imu_times, sd.gyro, guess) == \
            j_refine(sd.frame_times, q, sd.imu_times, sd.gyro, guess)


@pytest.mark.parametrize("rotation_only", [False, True])
def test_imu_residuals_and_jacobians_match_jax(vi, rotation_only):
    W = J_WEIGHTS(vi["state_j"], vi["data_j"].imu)
    out_j = J_RES_JAC(vi["state_j"], vi["data_j"].imu, W,
                      jnp.asarray(rotation_only))
    out_t = t_rj(vi["state_t"], vi["data_t"].imu, torch.as_tensor(
        np.asarray(W)), rotation_only)
    for name, a, b in zip(["r", "J1", "J2", "J_sh"], out_j, out_t):
        assert tuple(b.shape) == tuple(a.shape), name
        _rel_close(b.numpy(), a, 1e-9)


def test_imu_weights_match_jax_with_fallback(vi):
    """Factor 0 has no measurements and factor 1 a NaN gyro sample: both
    must fall back to the I*500 seed weight.  Factor 2's window collapses
    to zero length (start == end): finite and equal to JAX."""
    d = _imu_dict(vi["data_j"].imu)
    d["has_meas"] = d["has_meas"].copy()
    d["has_meas"][0] = False
    d["win_gyro"] = d["win_gyro"].copy()
    d["win_gyro"][1, 5, 1] = np.nan
    d["end"] = d["end"].copy()
    d["end"][2] = d["start"][2]
    imu_j = JImu(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                    for k, v in d.items()})
    pd = _problem_dict(vi["data_j"])
    pd["imu"] = d
    imu_t = convert.problem_from_numpy(pd, "cpu").imu
    W_j = np.asarray(J_WEIGHTS(vi["state_j"], imu_j))
    W_t = tw.imu_weights(vi["state_t"], imu_t).numpy()
    seed = np.eye(9) * 500.0
    for k in (0, 1):
        np.testing.assert_array_equal(W_j[k], seed)
        np.testing.assert_array_equal(W_t[k], seed)
    assert np.isfinite(W_t).all()
    for k in range(2, len(W_j)):
        _rel_close(W_t[k], W_j[k], 1e-8)


@pytest.mark.parametrize("path", ["consecutive", "segment_sum"])
@pytest.mark.parametrize("stage", ["rotation", "full+scale"])
def test_assemble_with_imu_matches_jax(vi, path, stage):
    kw = (dict(inertial_active=True, rotation_only=True) if stage ==
          "rotation" else dict(inertial_active=True, rotation_only=False,
                               bias_active=True, scale_active=True))
    fj, ft = _flags(**kw)
    data_j, data_t = vi["data_j"], vi["data_t"]
    if path == "segment_sum":
        data_j = dataclasses.replace(data_j, imu=dataclasses.replace(
            data_j.imu, consecutive=False))
        data_t = dataclasses.replace(data_t, imu=dataclasses.replace(
            data_t.imu, consecutive=False))
    (fm_j, sm_j), (fm_t, sm_t) = _masks(data_j, data_t, fj, ft)
    W = J_WEIGHTS(vi["state_j"], data_j.imu)
    out_j = J_ASSEMBLE(vi["state_j"], data_j, W, fm_j, sm_j,
                       jnp.asarray(1.0), jnp.asarray(fj.rotation_only))
    W_t = torch.as_tensor(np.asarray(W))
    out_t = ta.assemble(vi["state_t"], data_t, W_t, fm_t, sm_t,
                        torch.tensor(1.0, dtype=F64), ft.rotation_only)
    for name, a, b in zip(["D", "U", "Hfs", "Hss", "gf", "gs", "cost",
                           "n_res"], out_j, out_t):
        assert tuple(b.shape) == tuple(a.shape), name
        _rel_close(b.numpy(), a, 1e-9)
    cj = J_COSTS(vi["state_j"], data_j, W, jnp.asarray(1.0),
                 jnp.asarray(fj.rotation_only))
    ct = ta.robust_costs(vi["state_t"], data_t, W_t,
                         torch.tensor(1.0, dtype=F64), ft.rotation_only)
    for a, b in zip(cj, ct):
        _rel_close(b.numpy(), a, 1e-12)


def test_initializers_match_jax(vi):
    data_j, data_t = vi["data_j"], vi["data_t"]
    s0_j = vi["state0_j"]._replace(
        time_offset=jnp.asarray(0.004 + 0.03))
    s0_t = _to_t(s0_j)
    out_j = jst.initialize_time_offset(s0_j, data_j.imu, max_shift=0.1)
    out_t = tst.initialize_time_offset(s0_t, data_t.imu, max_shift=0.1)
    _states_close(out_t, out_j, 1e-10)
    pairs = [(out_j, out_t)]
    for fj_, ft_ in ((jst.initialize_extrinsic_rotation,
                      tst.initialize_extrinsic_rotation),
                     (jst.initialize_velocities,
                      tst.initialize_velocities)):
        sj, st = pairs[-1]
        pairs.append((fj_(sj, data_j.imu), ft_(st, data_t.imu)))
        _states_close(pairs[-1][1], pairs[-1][0], 1e-10)
    sj, st = pairs[-1]
    gj = jst.initialize_gravity(sj, data_j.imu, data_j.n_frames)
    gt = tst.initialize_gravity(st, data_t.imu, data_t.n_frames)
    _states_close(gt, gj, 1e-10)
    # the Wahba step moved camera 0 from identity (|q.q_true| = 0.5) to
    # within ~8 deg of the RDF rotation on this short, noisy sequence
    q_true = vi["cfg"].cameras[0].T_ck[0]
    dq = np.abs(np.dot(pairs[1][1].q_ck[0].numpy(), q_true))
    assert dq > 0.995


def test_one_lm_step_with_imu_matches_jax(vi):
    fj, ft = _flags(inertial_active=True, rotation_only=False,
                    bias_active=True)
    data_j, data_t = vi["data_j"], vi["data_t"]
    (fm_j, sm_j), (fm_t, sm_t) = _masks(data_j, data_t, fj, ft)
    W = J_WEIGHTS(vi["state_j"], data_j.imu)
    lam = 1e-4
    new_j, lam_j, cost_j, trial_j, acc_j, gnorm_j = jlm.lm_step_jit(
        data_j, vi["state_j"], jnp.asarray(lam), W, fm_j, sm_j,
        jnp.asarray(1.0), jnp.asarray(False), jlm.LMOptions())
    (new_t, lam_t, _, cost_t, trial_t, acc_t, gnorm_t,
     _) = tlm._lm_step(data_t, vi["state_t"], torch.tensor(lam, dtype=F64),
                       torch.tensor(2.0, dtype=F64),
                       torch.as_tensor(np.asarray(W)), fm_t, sm_t,
                       torch.tensor(1.0, dtype=F64), False, tlm.LMOptions())
    assert bool(acc_t) == bool(acc_j) and bool(acc_t)
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-12)
    np.testing.assert_allclose(float(trial_t), float(trial_j), rtol=1e-9)
    np.testing.assert_allclose(float(lam_t), float(lam_j), rtol=1e-6)
    np.testing.assert_allclose(float(gnorm_t), float(gnorm_j), rtol=1e-9)
    _states_close(new_t, new_j, 1e-9)


def _j_covariance(state, data, flags):
    """The JAX package's shared_covariance with its two device programs
    (imu_weights, assemble) jitted, as its solver runs them; op by op they
    take minutes on the CPU."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jw, "imu_weights", J_WEIGHTS)
    mp.setattr(ja, "assemble", J_ASSEMBLE)
    try:
        return jst.shared_covariance(state, data, flags)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def staged(vi):
    """The whole staged VI schedule in both packages from the same
    PnP-seeded state (the run_staged tests share it).  Function tolerance
    1e-4 in both: at the default 1e-6 the 12-frame problem churns for
    hundreds of iterations in both packages (the whitening refresh)."""
    fj, ft = _flags(optimize_time_offset=True)
    data_t = convert.problem_from_numpy(_problem_dict(vi["data_j"]), "cpu")
    res_j = jst.run_staged(vi["state0_j"], vi["data_j"], fj,
                           jlm.LMOptions(function_tolerance=1e-4))
    res_t = tst.run_staged(_to_t(vi["state0_j"]), data_t, ft,
                           tlm.LMOptions(function_tolerance=1e-4),
                           compute_cov=True)
    final = fj.evolve(inertial_active=True, rotation_only=False,
                      bias_active=True, scale_active=True)
    cov_j = _j_covariance(res_j.state, vi["data_j"], final)
    return res_j, res_t, cov_j


def test_run_staged_vi_matches_jax(vi, staged):
    """Same stages and iteration counts; final states within the slack LM
    leaves at the 1e-6 function tolerance.  Both runs start from the same
    state and take the same accept/reject decisions, so they stay within
    ~1e-9 (measured) of each other; the bounds below leave room for
    rounding to move a stopping decision by one iteration's step."""
    res_j, res_t, _ = staged
    assert [r[:2] for r in res_t.stages_run] == \
        [r[:2] for r in res_j.stages_run]
    for (_, _, c_j, _), (_, _, c_t, _) in zip(res_j.stages_run,
                                               res_t.stages_run):
        np.testing.assert_allclose(c_t, c_j, rtol=1e-6)
    sj, st = res_j.state, res_t.state
    np.testing.assert_allclose(st.intr.numpy(), np.asarray(sj.intr),
                               rtol=0, atol=5e-3)
    for name in ("q_ck", "p_ck", "biases", "scales", "g_dir", "v_w"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)), rtol=0,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(float(st.time_offset),
                               float(sj.time_offset), rtol=0, atol=1e-6)
    # both find the simulated camera-IMU rotation to a few degrees (12
    # noisy frames, stopped at a 1e-4 function tolerance)
    q_true = vi["cfg"].cameras[0].T_ck[0]
    assert np.abs(np.dot(st.q_ck[0].numpy(), q_true)) > 0.998


def test_shared_covariance_matches_jax(vi, staged):
    """At each package's own solution (within the slack above) the marginal
    covariances agree to 1e-4 relative to their largest entry: the
    covariance is a smooth function of the state.  At one state they agree
    to 1e-6: the covariance's condition number here is ~4e8, which turns
    the assembled systems' 1e-13-level differences into ~4e-8."""
    _, res_t, cov_j = staged
    cov_t = res_t.covariance
    assert cov_t.shape == cov_j.shape == (vi["data_t"].layout.size,) * 2
    assert np.isfinite(cov_t).all()
    _rel_close(cov_t, cov_j, 1e-4)
    # the same state through both: float64 rounding only
    fj, ft = _flags(inertial_active=True, rotation_only=False,
                    bias_active=True, scale_active=True)
    c_j = _j_covariance(vi["state_j"], vi["data_j"], fj)
    c_t = tst.shared_covariance(vi["state_t"], vi["data_t"], ft)
    _rel_close(c_t, c_j, 1e-6)
    names = [n for n, _, _ in vi["data_t"].layout.block_names()]
    assert names == [n for n, _, _ in vi["data_j"].layout.block_names()]


def test_weight_refresh_cadence(monkeypatch):
    """The covariance weights are recomputed on refresh iterations and
    once after the loop, and only in a stage that uses them with IMU
    factors and sigmas; otherwise the loop's seed weights stay."""
    assert tlm.LMOptions().weight_refresh == jlm.LMOptions().weight_refresh
    ran = []
    monkeypatch.setattr(tlm, "_step_body",
                        lambda data, loop, rot, opts: ran.append("step"))
    monkeypatch.setattr(tlm, "_weights_body",
                        lambda data, loop, sigmas: ran.append("weights"))
    loop = type("L", (), {"converged": torch.tensor(False)})()
    opts = tlm.LMOptions(max_iters=9)
    for use_cov, imu, sigmas, want in (
            (True, object(), (1.0, 1.0),
             (["weights"] + ["step"] * 4) * 2 + ["weights", "step",
                                                 "weights"]),
            (False, object(), (1.0, 1.0), ["step"] * 9),
            (True, None, (1.0, 1.0), ["step"] * 9),
            (True, object(), None, ["step"] * 9)):
        ran.clear()
        data = tlm.ProblemData(obs=[], imu=imu, layout=None, n_frames=0)
        assert tlm._iterate(data, loop, False, use_cov, opts, sigmas) == \
            (9, False)
        assert ran == want


def test_row_major_assemble_with_imu_matches_jax(vi):
    """Each camera's rows shuffled (not frame-major), the IMU factors as
    they are: the port's row-major assembly against JAX's assembly of the
    frame-major problem (JAX's two layouts agree to ~3e-14 of the largest
    entry on this problem, measured; the jitted program is the one
    test_assemble_with_imu_matches_jax compiled)."""
    fj, ft = _flags(inertial_active=True, rotation_only=False,
                    bias_active=True, scale_active=True)
    data_j = vi["data_j"]
    rng = np.random.default_rng(11)
    data_t = dataclasses.replace(vi["data_t"], obs=[
        dataclasses.replace(o, frame_idx=o.frame_idx[p], p_w=o.p_w[p],
                            p_c=o.p_c[p], valid=o.valid[p],
                            points_per_frame=None)
        for o in vi["data_t"].obs
        for p in [torch.as_tensor(rng.permutation(len(o.frame_idx)))]])
    (fm_j, sm_j), (fm_t, sm_t) = _masks(data_j, data_t, fj, ft)
    W = J_WEIGHTS(vi["state_j"], data_j.imu)
    out_j = J_ASSEMBLE(vi["state_j"], data_j, W, fm_j, sm_j,
                       jnp.asarray(1.0), jnp.asarray(False))
    W_t = torch.as_tensor(np.asarray(W))
    one = torch.tensor(1.0, dtype=F64)
    out_t = ta.assemble(vi["state_t"], data_t, W_t, fm_t, sm_t, one, False)
    for name, a, b in zip(["D", "U", "Hfs", "Hss", "gf", "gs", "cost",
                           "n_res"], out_j, out_t):
        _rel_close(b.numpy(), a, 1e-9)
    cj = J_COSTS(vi["state_j"], data_j, W, jnp.asarray(1.0),
                 jnp.asarray(False))
    ct = ta.robust_costs(vi["state_t"], data_t, W_t, one, False)
    for a, b in zip(cj, ct):
        _rel_close(b.numpy(), a, 1e-12)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_shard_problem_matches_jax(vi, n_shards):
    """Contiguous shards, padded at the end (3 shards do not divide the
    rows): equal to JAX's array for array, stacked as JAX stacks them."""
    sh_j = jsh.shard_problem(vi["data_j"], n_shards)
    sh_t = tsh.shard_problem(vi["data_t"], n_shards)
    assert len(sh_t) == len(sh_j) == n_shards
    st_j, st_t = jsh.stack_shards(sh_j), tsh.stack_shards(sh_t)
    for f in ("obs_frame_idx", "obs_p_w", "obs_p_c", "obs_valid"):
        for a, b in zip(getattr(st_j, f), getattr(st_t, f)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), f)
    for f, a in st_j.imu.items():
        np.testing.assert_array_equal(st_t.imu[f].numpy(), np.asarray(a), f)
    for j, t in zip(sh_j, sh_t):
        assert t.n_frames == j.n_frames
        assert dataclasses.asdict(t.layout) == dataclasses.asdict(j.layout)
        assert all(o.points_per_frame is None for o in t.obs)
        assert not t.imu.consecutive


@pytest.fixture(scope="module")
def jax_step(vi):
    """JAX's single-device LM step at the VI fixture's state (the inputs of
    test_one_lm_step_with_imu_matches_jax, so its jitted program)."""
    fj, ft = _flags(inertial_active=True, rotation_only=False,
                    bias_active=True)
    (fm_j, sm_j), masks_t = _masks(vi["data_j"], vi["data_t"], fj, ft)
    W = J_WEIGHTS(vi["state_j"], vi["data_j"].imu)
    out = jlm.lm_step_jit(
        vi["data_j"], vi["state_j"], jnp.asarray(1e-4), W, fm_j, sm_j,
        jnp.asarray(1.0), jnp.asarray(False), jlm.LMOptions())
    return out, torch.as_tensor(np.asarray(W)), masks_t


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_sharded_lm_step_matches_jax(vi, jax_step, n_shards):
    (new_j, lam_j, cost_j, trial_j, acc_j, gnorm_j), W, (fm_t, sm_t) = \
        jax_step
    sh = ShardedLMStep(vi["data_t"], mesh=make_mesh(n_shards, device="cpu"))
    assert sh.n_shards == n_shards
    (new_t, lam_t, _, cost_t, trial_t, acc_t, gnorm_t, _) = sh.make_step()(
        vi["state_t"], torch.tensor(1e-4, dtype=F64),
        torch.tensor(2.0, dtype=F64), sh.sharded_weight(W), fm_t, sm_t,
        torch.tensor(1.0, dtype=F64), False)
    assert bool(acc_t) == bool(acc_j)
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-12)
    np.testing.assert_allclose(float(trial_t), float(trial_j), rtol=1e-8)
    np.testing.assert_allclose(float(lam_t), float(lam_j), rtol=1e-6)
    np.testing.assert_allclose(float(gnorm_t), float(gnorm_j), rtol=1e-8)
    _states_close(new_t, new_j, 1e-9)


def test_run_staged_sharded_matches_jax(vi, staged):
    """The port's staged schedule over 2 shards against JAX's
    single-device staged result, with tests/test_dist.py's tolerances for
    JAX's own sharded schedule."""
    res_j = staged[0]
    fj, ft = _flags(optimize_time_offset=True)
    # one intra-op thread: the solve is thousands of tiny ops, which run
    # faster without thread hand-offs, most of all on a busy machine
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res_t = tst.run_staged(_to_t(vi["state0_j"]), vi["data_t"], ft,
                               tlm.LMOptions(function_tolerance=1e-4),
                               mesh=make_mesh(2, device="cpu"))
    finally:
        torch.set_num_threads(threads)
    assert [r[0] for r in res_t.stages_run] == \
        [r[0] for r in res_j.stages_run]
    sj, st = res_j.state, res_t.state
    np.testing.assert_allclose(res_t.cam_rmse, res_j.cam_rmse, rtol=2e-3)
    np.testing.assert_allclose(st.q_ck.numpy(), np.asarray(sj.q_ck),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.biases.numpy(), np.asarray(sj.biases),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(st.time_offset),
                               float(sj.time_offset), rtol=0, atol=1e-5)
