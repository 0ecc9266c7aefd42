"""Staged optimization schedule — the reference's SolveThread state machine.

Stage progression (reference: vicalibrator.h:919-1031):

  1. visual-only                          (camera-0 extrinsics fixed: gauge)
  2. + inertial, rotation-only            (T_ck rotation free, g/bias const)
  3. + translation, gravity, biases       (gravity initialized from the
                                           middle frame's accelerometer,
                                           :927-949; biases activate together
                                           with translation, :982-990)
  4. + scale factors                      (:991-994)
  5. outlier removal + one re-solve       (:995-998, 859-916; opt-in)

In the full inertial stages the IMU whitening weights are recomputed from
covariance propagation through the integration (UpdateImuWeights,
:723-799; see weights.py).  The state initializers between stages run on
the device with no host read; the stage infos come back to the host once,
at the end.
"""
from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from ..geometry import so3
from ..imu import preintegrate
from .assemble import ProblemData
from .lm import LMInfo, LMOptions, LMSolver, materialize_info, seed_weights
from .problem import CalibState, StageFlags, frame_mask, shared_mask
from .residuals import reproj_residuals
from .weights import IMU_ACCEL_SIGMA, IMU_GYRO_SIGMA

log = logging.getLogger("vicalib_tpu_torch.solver")


@dataclasses.dataclass
class StagedResult:
    state: CalibState
    info: LMInfo
    stages_run: list               # (name, iters, cost, wall_s) per stage
    mse: float
    cam_rmse: np.ndarray
    total_iterations: int
    covariance: np.ndarray = None  # (S, S) shared-parameter covariance


def interp(x, xp, fp):
    """``jnp.interp`` / ``np.interp`` batched: x (..., Q) queries into the
    sorted stamps xp (..., M) with values fp (..., M) -> (..., Q).  Queries
    outside [xp[0], xp[-1]] clamp to the end values; the arithmetic (and so
    the rounding) is jnp.interp's."""
    M = xp.shape[-1]
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(),
                                       right=True), 1, M - 1)
    x_lo = torch.gather(xp, -1, i - 1)
    f_lo = torch.gather(fp, -1, i - 1)
    df = torch.gather(fp, -1, i) - f_lo
    dx = torch.gather(xp, -1, i) - x_lo
    delta = x - x_lo
    dx0 = torch.abs(dx) <= np.spacing(torch.finfo(xp.dtype).eps)
    f = torch.where(dx0, f_lo,
                    f_lo + (delta / torch.where(dx0, torch.ones_like(dx),
                                                dx)) * df)
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def _interp3(t, times, vals):
    """Per-factor streams interpolated at per-factor times: t (K, Q),
    times (K, M), vals (K, M, 3) -> (K, Q, 3)."""
    return torch.stack([interp(t, times, vals[..., c]) for c in range(3)],
                       dim=-1)


def _pair_rates(imu):
    """dt, validity weight and safe dt of each consecutive-frame factor."""
    dt = imu.end - imu.start
    valid = ((dt > 0) & imu.has_meas).to(dt.dtype)
    safe_dt = torch.where(dt > 0, dt, torch.ones_like(dt))
    return dt, valid, safe_dt


def initialize_time_offset(state: CalibState, imu, max_shift: float,
                           n_cand: int = 129) -> CalibState:
    """Coarse camera<->IMU time alignment by gyro/vision cross-correlation.

    The LM refinement of the time offset only converges within its local
    basin (~10 ms for typical motion); a first-IMU-sample alignment guess
    (vicalib-task.cc:633-653) can be 100+ ms off when the streams don't
    start simultaneously.  The *magnitude* of the body angular rate is
    rotation-invariant, so scan candidate offsets and pick the one where
    |gyro(t_mid - d)| best matches the camera-derived angular speed
    |log(q_k^-1 q_{k+1})| / dt.  Runs on the device; the grid spans
    +-max_shift (the window slack — samples beyond it aren't in the factor
    windows) around the current offset.  A design addition: the reference
    has no basin-escape mechanism.
    """
    dtype = state.t_wk.dtype
    _, valid, safe_dt = _pair_rates(imu)
    dq_k = so3.quat_mul(so3.inverse(state.q_wk[:-1]), state.q_wk[1:])
    omega_mag = torch.linalg.norm(so3.log(dq_k), dim=1) / safe_dt
    t_mid = 0.5 * (imu.start + imu.end)
    ds = state.time_offset + torch.linspace(
        -max_shift, max_shift, n_cand, dtype=dtype, device=t_mid.device)
    zg = _interp3(t_mid[:, None] - ds[None, :], imu.win_times,
                  imu.win_gyro)                             # (K, n_cand, 3)
    mag = torch.linalg.norm(zg - state.biases[:3], dim=2)
    costs = torch.sum(valid[:, None] * (mag - omega_mag[:, None]) ** 2,
                      dim=0)
    best = torch.argmin(costs)
    return state._replace(
        time_offset=torch.index_select(ds, 0, best.reshape(1))[0])


def initialize_extrinsic_rotation(state: CalibState, imu) -> CalibState:
    """Jump-start camera-0's extrinsic rotation by gyro/vision alignment.

    The IMU residual has no *direct* dependence on R_ck — the coupling is
    second-order through the frame poses — so descending from identity to a
    large rotation (e.g. the RDF permutation, ~120 deg) crawls.  The
    reference burns trust-region iterations on this (vicalibrator.h:976-985);
    here the classic Wahba alignment is solved first:

      gyro body rate  z_g(t)  ~  R_ck^T  omega_cam(t)

    with omega_cam from consecutive PnP camera orientations, then frames are
    re-anchored (T_wk <- T_wk * dT_ck) so reprojection is untouched; the
    least-squares gyro bias given the fitted rotation is seeded as well
    (the residual adds the stored bias to the measurement:
    omega_body = z_g + b_g).  Runs on the device with no host read.  A
    design addition (the reference starts from identity/zero,
    vicalib-engine.cc:273-274).

    ``imu``: consecutive-factor ImuFactors.
    """
    _, valid, safe_dt = _pair_rates(imu)
    # camera (= rig, T_ck = I at this point) body angular velocity per pair
    dq_k = so3.quat_mul(so3.inverse(state.q_wk[:-1]), state.q_wk[1:])
    omega = so3.log(dq_k) / safe_dt[:, None]
    t_mid = 0.5 * (imu.start + imu.end) - state.time_offset
    zg = _interp3(t_mid[:, None], imu.win_times, imu.win_gyro)[:, 0] \
        - state.biases[:3]

    # Wahba: R_hat = argmin sum |z_g - R omega_c|^2  =>  R_ck = R_hat^T.
    # The rotation U diag(1, 1, det) V^T does not depend on the SVD's sign
    # conventions.
    B = torch.einsum("k,ki,kj->ij", valid, zg, omega)
    Uu, _, Vt = torch.linalg.svd(B)
    d = torch.linalg.det(Uu @ Vt)
    R_hat = (Uu * torch.stack([torch.ones_like(d), torch.ones_like(d), d])) \
        @ Vt
    q_new = so3.from_matrix(R_hat.T)

    n_valid = torch.clamp(torch.sum(valid), min=1.0)
    bg_init = torch.einsum("k,ki->i", valid, omega @ R_hat.T - zg) / n_valid
    biases = torch.cat([state.biases[:3] + bg_init, state.biases[3:]])

    # dT = T_ck_old^-1 * T_ck_new (rotation only); re-anchor frames AND
    # every camera's extrinsics so all reprojections are untouched
    dq = so3.quat_mul(so3.inverse(state.q_ck[0]), q_new)
    return state._replace(q_wk=so3.quat_mul(state.q_wk, dq[None, :]),
                          q_ck=so3.quat_mul(state.q_ck, dq[None, :]),
                          biases=biases)


def initialize_velocities(state: CalibState, imu) -> CalibState:
    """Seed frame velocities by central differences of the (visually
    refined) frame positions.  The reference leaves velocities at zero and
    lets the solver pull them in (vicalibrator.h:603-604); seeding them
    removes several LM iterations of purely linear cleanup.  A design
    addition, not reference behavior.
    """
    t_wk = state.t_wk
    times = torch.cat([imu.start, imu.end[-1:]])
    F = t_wk.shape[0]
    if F < 2 or times.shape[0] != F:
        return state
    dt = torch.clamp(times[1:] - times[:-1], min=1e-6)
    v_mid = (t_wk[2:] - t_wk[:-2]) / torch.clamp(
        times[2:] - times[:-2], min=1e-6)[:, None]
    v = torch.cat([((t_wk[1] - t_wk[0]) / dt[0])[None], v_mid,
                   ((t_wk[-1] - t_wk[-2]) / dt[-1])[None]])
    return state._replace(v_w=v.to(t_wk.dtype))


def initialize_gravity(state: CalibState, imu, n_frames: int) -> CalibState:
    """Estimate the 2-angle gravity direction from the middle frame's
    accelerometer reading rotated into the world (vicalibrator.h:927-949),
    then seed the least-squares accel bias given gravity and the seeded
    velocities: the residual model is a_w = R(z_a + b_a) - g_w
    (preintegrate), so b_a = mean_k[ R^T (a_w + g_w) - z_a ] with a_w from
    velocity finite differences (the bias seed is a design addition; the
    reference starts at zero)."""
    dtype = state.g_dir.dtype
    k = min(n_frames // 2, int(imu.start.shape[0]) - 1)
    t_query = imu.start[k] - state.time_offset
    accel = _interp3(t_query.reshape(1, 1), imu.win_times[k:k + 1],
                     imu.win_accel[k:k + 1])[0, 0]
    g_b = accel / torch.linalg.norm(accel)
    g_w = so3.rotate(state.q_wk[k], g_b)
    p = torch.arcsin(torch.clamp(g_w[1], -1, 1))
    cp = torch.cos(p)
    safe_cp = torch.where(torch.abs(cp) > 1e-9, cp,
                          torch.full_like(cp, 1e-9))
    q = torch.arcsin(torch.clamp(-g_w[0] / safe_cp, -1, 1))
    state = state._replace(g_dir=torch.stack([p, q]).to(dtype))

    _, valid, safe_dt = _pair_rates(imu)
    t_mid = 0.5 * (imu.start + imu.end) - state.time_offset
    z_a = _interp3(t_mid[:, None], imu.win_times, imu.win_accel)[:, 0]
    a_w = (state.v_w[1:] - state.v_w[:-1]) / safe_dt[:, None]
    g_w_vec = preintegrate.gravity_vector(state.g_dir)
    ba_k = so3.rotate(so3.inverse(state.q_wk[:-1]), a_w + g_w_vec) - z_a
    n_valid = torch.clamp(torch.sum(valid), min=1.0)
    ba = torch.einsum("k,ki->i", valid, ba_k) / n_valid
    return state._replace(
        biases=torch.cat([state.biases[:3], state.biases[3:] + ba]))


def remove_outliers(state: CalibState, data: ProblemData, cam_rmse,
                    threshold: float) -> ProblemData:
    """Invalidate observations with reprojection error above
    threshold * per-camera RMSE (RemoveOutliers, vicalibrator.h:859-916)."""
    new_obs = []
    for c, obs in enumerate(data.obs):
        r = reproj_residuals(state, obs, c, data.layout.model_names[c])
        err = torch.linalg.norm(r, dim=1)
        keep = (err <= threshold * float(cam_rmse[c])) & (obs.valid > 0)
        n_out = int(torch.sum((obs.valid > 0) & ~keep))
        log.info("camera %d: removing %d/%d conic outliers", c, n_out,
                 int(torch.sum(obs.valid > 0)))
        new_obs.append(dataclasses.replace(obs, valid=keep.to(obs.valid.dtype)))
    return dataclasses.replace(data, obs=new_obs)


def run_staged(state: CalibState, data: ProblemData, flags: StageFlags,
               options: LMOptions = LMOptions(),
               do_remove_outliers: bool = False,
               outlier_threshold: float = 2.0,
               gyro_sigma=IMU_GYRO_SIGMA, accel_sigma=IMU_ACCEL_SIGMA,
               stats_callback=None, checkpoint_path: str = None,
               compute_cov: bool = False,
               resume: bool = False) -> StagedResult:
    """Run the full staged schedule to completion on the problem's device.

    ``flags`` carries the starting stage configuration (VicalibTask::Start
    maps has_initial_guess here, vicalib-task.cc:227-235).  With ``resume``
    (state+flags loaded from a checkpoint) the one-time state
    initializations are skipped — the checkpointed stage re-solves from its
    converged state and the schedule continues from there.

    ``stats_callback`` gets one dict per stage (stage, cost, iterations,
    cam_rmse, wall_s, state) and ``checkpoint_path`` is rewritten after
    every stage.  With either observer, or DEBUG logging, each stage's info
    comes to the host after its solve (one device-to-host copy per stage);
    with none, every stage's info comes back in one transfer at the end.
    """
    sigmas = None
    if data.imu is not None and flags.calibrate_imu:
        sigmas = (float(gyro_sigma), float(accel_sigma))
    solver = LMSolver(data, options, sigmas=sigmas)
    dtype = state.t_wk.dtype
    dev = state.t_wk.device
    pending = []                      # (stage_name, raw_info, wall)
    outliers_removed = False
    gravity_initialized = resume
    extrinsic_rot_initialized = resume
    lazy = (stats_callback is None and not checkpoint_path
            and not log.isEnabledFor(logging.DEBUG))

    while True:
        fmask = frame_mask(flags, data.n_frames, dtype, dev)
        smask = shared_mask(data.layout, flags, dtype, dev)
        inertial = flags.calibrate_imu and flags.inertial_active
        full_inertial = inertial and not flags.rotation_only

        if (inertial and flags.rotation_only
                and not extrinsic_rot_initialized):
            if (flags.optimize_time_offset and data.imu is not None
                    and data.imu.slack > 0):
                state = initialize_time_offset(state, data.imu,
                                               max_shift=data.imu.slack)
            state = initialize_extrinsic_rotation(state, data.imu)
            extrinsic_rot_initialized = True

        if full_inertial and not gravity_initialized:
            state = initialize_velocities(state, data.imu)
            state = initialize_gravity(state, data.imu, data.n_frames)
            gravity_initialized = True

        stage_name = (
            "visual" if not inertial else
            "inertial-rotation" if flags.rotation_only else
            "inertial-full%s" % ("+scale" if flags.scale_active else ""))
        log.info("=== stage: %s ===", stage_name)
        t_stage = time.time()
        state, raw = solver.solve(
            state, fmask, smask, use_cov_weights=full_inertial,
            inertial_scale=1.0 if inertial else 0.0,
            rotation_only=flags.rotation_only, lazy=True)
        wall = time.time() - t_stage
        pending.append((stage_name, raw, wall))
        if not lazy:
            _observe_stage(stage_name, raw, wall, state, flags, solver,
                           sigmas, full_inertial, stats_callback,
                           checkpoint_path)

        # stage advance (vicalibrator.h:976-1031)
        if flags.calibrate_imu and not flags.inertial_active:
            flags = flags.evolve(inertial_active=True, rotation_only=True)
        elif flags.calibrate_imu and flags.rotation_only:
            flags = flags.evolve(rotation_only=False, bias_active=True)
        elif flags.calibrate_imu and not flags.scale_active:
            flags = flags.evolve(scale_active=True)
        elif do_remove_outliers and not outliers_removed:
            info = materialize_info(raw)
            data = remove_outliers(state, data, info.cam_rmse,
                                   outlier_threshold)
            solver = LMSolver(data, options, sigmas=sigmas)
            outliers_removed = True
        else:
            break

    # every stage's info with one device->host transfer
    all_vecs = torch.stack([raw for _, raw, _ in pending]).cpu().numpy()
    stages_run = []
    total_iters = 0
    for (stage_name, _, wall), vec in zip(pending, all_vecs):
        info = materialize_info(vec)
        stages_run.append((stage_name, info.iterations, info.cost, wall))
        total_iters += info.iterations
        log.info("stage %-22s iters %3d cost %.6e rmse %s",
                 stage_name, info.iterations, info.cost, info.cam_rmse)
    mse = info.cost / max(info.n_residuals, 1)
    covariance = None
    if compute_cov:
        covariance = shared_covariance(state, data, flags, gyro_sigma,
                                       accel_sigma)
    return StagedResult(state=state, info=info, stages_run=stages_run,
                        mse=mse, cam_rmse=info.cam_rmse,
                        total_iterations=total_iters, covariance=covariance)


def _observe_stage(stage_name, raw, wall, state, flags, solver, sigmas,
                   full_inertial, stats_callback, checkpoint_path):
    """The per-stage log, DEBUG IMU consistency log, stats callback and
    checkpoint of a stage that just finished."""
    info = materialize_info(raw)
    log.info("stage %s done: cost %.6e rmse %s iters %d wall %.2fs",
             stage_name, info.cost, info.cam_rmse, info.iterations, wall)
    if full_inertial and log.isEnabledFor(logging.DEBUG):
        # per-factor Mahalanobis distance of the whitened IMU residuals vs
        # chi2inv(0.95, 9) = 16.919 (UpdateImuWeights' consistency log,
        # vicalibrator.h:747-797)
        from .residuals import imu_residuals
        from .weights import imu_weights
        W_dbg = imu_weights(state, solver.data.imu, sigmas[0], sigmas[1])
        r_dbg = imu_residuals(state, solver.data.imu, W_dbg,
                              False).cpu().numpy()
        mahal = np.sum(r_dbg * r_dbg, axis=1)
        n_bad = int(np.sum(mahal > 16.919))
        log.debug("IMU Mahalanobis: median %.3f max %.3f; %d/%d factors "
                  "over chi2inv(0.95,9)=16.919", float(np.median(mahal)),
                  float(mahal.max()), n_bad, len(mahal))
    if stats_callback is not None:
        # per-stage progress publication (the reference's 30 ms stats
        # polling loop, vicalib-engine.cc:388-432): stage boundaries are
        # the cadence
        stats_callback({"stage": stage_name, "cost": float(info.cost),
                        "iterations": int(info.iterations),
                        "cam_rmse": np.asarray(info.cam_rmse),
                        "wall_s": wall, "state": state})
    if checkpoint_path:
        from ..checkpoint import save_checkpoint
        save_checkpoint(checkpoint_path, state, flags,
                        meta={"stage": stage_name, "cost": float(info.cost),
                              "iterations": int(info.iterations)})


def _to_f64(x):
    return x.to(torch.float64) if torch.is_floating_point(x) else x


def _fields_to_f64(obj):
    """A dataclass of tensors with its floating-point fields in float64."""
    return dataclasses.replace(obj, **{
        f.name: _to_f64(getattr(obj, f.name))
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def shared_covariance(state: CalibState, data: ProblemData,
                      flags: StageFlags, gyro_sigma=IMU_GYRO_SIGMA,
                      accel_sigma=IMU_ACCEL_SIGMA):
    """Marginal covariance of the shared parameters at the solution.

    Reference analog: GetSolutionCovariance (vicalibrator.h:802-857, opt-in
    via COMPUTE_VICALIB_COVARIANCE).  With frames Schur-eliminated, the
    marginal covariance of the shared block is exactly the inverse of the
    reduced system S_red = C - B^T A^-1 B evaluated undamped at the solution;
    inactive tangent entries carry identity rows/cols.

    Always float64 on the state's device (the reduced system's conditioning,
    ~1e12, exceeds float32); the final (S, S) inverse runs in host numpy.
    """
    from .assemble import assemble
    from .schur import tridiag_solve
    from .weights import imu_weights

    state = CalibState(*[_to_f64(x) for x in state])
    data = dataclasses.replace(
        data, obs=[_fields_to_f64(o) for o in data.obs],
        imu=None if data.imu is None else _fields_to_f64(data.imu))
    dtype = torch.float64
    dev = state.t_wk.device
    fmask = frame_mask(flags, data.n_frames, dtype, dev)
    smask = shared_mask(data.layout, flags, dtype, dev)
    inertial = flags.calibrate_imu and flags.inertial_active
    if data.imu is not None:
        if inertial and not flags.rotation_only:
            W = imu_weights(state, data.imu, gyro_sigma, accel_sigma)
        else:
            W = seed_weights(data.imu.start.shape[0], dtype, dev)
    else:
        W = None
    D, U, Hfs, Hss, gf, gs, _, _ = assemble(
        state, data, W, fmask, smask,
        torch.tensor(1.0 if inertial else 0.0, dtype=dtype, device=dev),
        flags.rotation_only)
    S = Hss.shape[0]
    eye = torch.eye(D.shape[1], dtype=dtype, device=dev)
    # relative jitter on the frame blocks and unit-diagonal scaling of the
    # reduced system
    eps = 1e-12
    dscale_f = torch.clamp(torch.diagonal(D, dim1=1, dim2=2), min=1e-20)
    D = D + eps * dscale_f[:, :, None] * eye[None]
    X = tridiag_solve(D, U, Hfs)
    S_red = Hss - torch.einsum("fis,fit->st", Hfs, X)
    d = torch.clamp(torch.diagonal(S_red), min=1e-20)
    dscale = 1.0 / torch.sqrt(d)
    S_scaled = (S_red * dscale[:, None] * dscale[None, :]
                + eps * torch.eye(S, dtype=dtype, device=dev))
    # final (S, S) inversion on the host (S ~ 25), as the JAX package does
    inv_scaled = np.linalg.inv(S_scaled.cpu().numpy())
    ds = dscale.cpu().numpy()
    return inv_scaled * ds[:, None] * ds[None, :]
