"""The check that decides ``correct``.

The reference is ``plainref``: a plain calibration of the same files, which
takes nothing of the program.  Once the window has closed it reads the
frames, their stamps and the IMU CSV the program read, detects the target
with its own plain detector (plainref/detect.py) and solves the whole
visual-inertial problem by one dense float64 Levenberg-Marquardt
(plainref/lm.py), started from the simulator's truth.  Every call of the
window is compared with it:

- ``intr_px``: the widest pixel displacement, over a grid of points spread
  across each frame, between the program's and the reference's camera
  model (one number for every intrinsic, distortion included);
- ``extr``: the widest difference of a camera's T_ck (read from
  cameras.xml's T_wc), translation and rotation together;
- ``gyro_bias``, ``accel_bias``: the widest difference of a bias component;
- ``time_offset_s``: the difference of the camera-IMU time offsets;
- ``gravity_rad``: the angle between the two gravity directions;
- ``pose_m``, ``pose_rad``: the widest difference of a frame's rig position
  and orientation in poses.txt;
- ``missing_poses``: frames with a pose on one side and not the other
  (exact: limit 0);
- streaming only: ``missing_chunks``, the chunks the frames make less
  the chunk estimates the call published (exact: limit 0).

The same comparison of the reference with the simulator's truth is
reported beside it (``truth``); it is not part of ``correct``: the rig's
sensor noise bounds how close any calibration comes to the truth.
"""
from __future__ import annotations

import glob
import os
import re
import xml.etree.ElementTree as ET

import numpy as np
import torch

from . import sim

_N = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def _nums(text):
    return np.array([float(x) for x in _N.findall(text)])


# ----------------------------------------------------------- numpy poses
def quat_from_matrix(R):
    return sim.quat_from_matrix(torch.as_tensor(
        np.asarray(R, np.float64))).numpy()


def quat_to_matrix(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def rotation_angle(R):
    """The angle of a rotation matrix, accurate near zero."""
    q = quat_from_matrix(R)
    return float(2.0 * np.arctan2(np.linalg.norm(q[:3]), abs(q[3])))


def se3_error(M_est, M_true):
    """|log(T_est T_true^-1)|, translation and rotation parts together."""
    D = M_est @ np.linalg.inv(M_true)
    w = rotation_angle(D[:3, :3])
    # the SE(3) log's translation is J_l(w)^-1 t: within 1 + |w| of |t|
    # for the small errors judged here, so |t| is used
    return float(np.hypot(np.linalg.norm(D[:3, 3]), w))


def _mat(q, t):
    M = np.eye(4)
    M[:3, :3] = quat_to_matrix(q)
    M[:3, 3] = t
    return M


# --------------------------------------------------------------- outputs
def read_cameras_xml(path):
    """[(params, T_wc 4x4)] per camera of a calibu-style cameras.xml."""
    cams = []
    for cam in ET.parse(path).getroot().findall("camera"):
        cm = cam.find("camera_model")
        T = np.eye(4)
        T[:3, :] = _nums(cam.find("pose").find("T_wc").text).reshape(3, 4)
        cams.append((_nums(cm.find("params").text), T))
    return cams


def read_log(path):
    """Biases, gravity angles, time offset and the stage rows of the
    result log (-output_log_file)."""
    with open(path) as f:
        text = f.read()
    out = {}
    for key in ("bw_ba", "G"):
        m = re.search(r"^%s= \[(.*?)\]" % key, text, re.S | re.M)
        out[key] = _nums(m.group(1)) if m else None
    m = re.search(r"^ts= (\S+)", text, re.M)
    out["ts"] = float(m.group(1)) if m else None
    out["stages"] = [(n, int(i)) for n, i in re.findall(
        r"^stage (\S+): iters=(\d+)", text, re.M)]
    return out


def read_poses(path):
    """poses.txt rows: x y z roll pitch yaw."""
    if not os.path.exists(path):
        return np.zeros((0, 6))
    rows = np.loadtxt(path, ndmin=2)
    return rows.reshape(-1, 6)


def _cart_to_matrix(row):
    x, y, z, r, p, yw = row
    cr, sr, cp, sp = np.cos(r), np.sin(r), np.cos(p), np.sin(p)
    cy, sy = np.cos(yw), np.sin(yw)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    M = np.eye(4)
    M[:3, :3] = Rz @ Ry @ Rx
    M[:3, 3] = (x, y, z)
    return M


# ----------------------------------------------------------- comparisons
def read_outputs(out_dir):
    """A call's outputs: per camera (params, T_ck 4x4), the biases,
    gravity angles, time offset and poses.txt rows; None where missing."""
    try:
        cams = read_cameras_xml(os.path.join(out_dir, "cameras.xml"))
        log = read_log(os.path.join(out_dir, "vicalibrator.log"))
    except (OSError, ET.ParseError, AttributeError, ValueError):
        return None
    # cameras.xml bakes the RDF permutation into T_wc (IMU rigs):
    # T_wc = T_ck^-1 * (RDF^-1, 0), so T_ck = (T_wc * (RDF, 0))^-1
    B = np.eye(4)
    B[:3, :3] = sim.RDF_ROBOTICS
    return {"cams": [(p, np.linalg.inv(T_wc @ B)) for p, T_wc in cams],
            "bw_ba": log["bw_ba"], "G": log["G"], "ts": log["ts"],
            "poses": read_poses(os.path.join(out_dir, "poses.txt"))}


def _cart(R, t):
    """A poses.txt row of a rig pose: x y z roll pitch yaw."""
    return [*t, np.arctan2(R[2, 1], R[2, 2]), -np.arcsin(R[2, 0]),
            np.arctan2(R[1, 0], R[0, 0])]


def truth_outputs(truth):
    """The outputs a perfect calibration of the simulated rig writes."""
    rig = truth.rig
    rows = [_cart(quat_to_matrix(q), t) for q, t in
            zip(truth.q_wk, truth.t_wk)]
    return {"cams": [(c.params, _mat(c.q_ck, c.t_ck)) for c in rig.cameras],
            "bw_ba": np.r_[rig.gyro_bias, rig.accel_bias], "G": rig.g_dir,
            "ts": rig.time_offset, "poses": np.array(rows)}


def read_pgm(path):
    with open(path, "rb") as f:
        data = f.read()
    magic, w, h, maxval, rest = data.split(maxsplit=4)
    assert magic == b"P5" and maxval == b"255", path
    return np.frombuffer(rest, np.uint8, int(w) * int(h)).reshape(
        int(h), int(w))


def _read_inputs(paths):
    """The files a call reads: frames and stamps per camera, IMU CSV."""
    cams = [sorted(glob.glob(os.path.join(d, "*.pgm"))) for d in paths["cams"]]
    stamps = np.loadtxt(os.path.join(paths["cams"][0], "timestamps.txt"))
    imu = {k: np.loadtxt(os.path.join(paths["imu"], k + ".txt"))
           for k in ("timestamp", "gyro", "accel")}
    return cams, np.atleast_1d(stamps), imu


def _initial_state(truth, sel, device):
    """The simulator's truth at the selected frames, as the reference's
    starting point."""
    from plainref import lm

    rig = truth.rig
    T = lambda x: torch.as_tensor(np.asarray(x, np.float64),
                                  dtype=torch.float64, device=device)
    R_wk = np.stack([quat_to_matrix(q) for q in truth.q_wk[sel]])
    return lm.State(
        R_wk=T(R_wk), t_wk=T(truth.t_wk[sel]), v_w=T(truth.v_wk[sel]),
        R_ck=T(np.stack([quat_to_matrix(c.q_ck) for c in rig.cameras])),
        t_ck=T(np.stack([c.t_ck for c in rig.cameras])),
        intr=[T(c.params) for c in rig.cameras], g_dir=T(rig.g_dir),
        bias=T(np.r_[rig.gyro_bias, rig.accel_bias]),
        scale=T(np.r_[rig.gyro_scale, rig.accel_scale]),
        offset=T(rig.time_offset))


def _outputs(st, visible):
    """A solved state in read_outputs' form; poses of the frames where
    any camera saw the target."""
    cams = []
    for c, k in enumerate(st.intr):
        M = np.eye(4)
        M[:3, :3] = st.R_ck[c].cpu().numpy()
        M[:3, 3] = st.t_ck[c].cpu().numpy()
        cams.append((k.cpu().numpy(), M))
    good = visible.any(axis=(0, 2))
    R, t = st.R_wk.cpu().numpy(), st.t_wk.cpu().numpy()
    return {"cams": cams,
            "bw_ba": st.bias.cpu().numpy(), "G": st.g_dir.cpu().numpy(),
            "ts": float(st.offset),
            "poses": np.array([_cart(R[f], t[f]) for f in np.where(good)[0]])
            .reshape(-1, 6)}


def plain_reference(conf, traffic, paths, truth, device, log=None):
    """The reference's outputs for the seed's files and, for a live
    traffic, the number of chunks its frames make (else None)."""
    from plainref import detect, lm

    cams, stamps, imu = _read_inputs(paths)
    # the frames a call calibrates: those after the first IMU sample (both
    # streams on the host's clock, the program's default)
    sel = np.where(stamps > imu["timestamp"][0])[0]
    pattern = truth.rig.target.grid
    try:
        det = [detect.detect_frames(np.stack([read_pgm(files[f])
                                              for f in sel]), pattern, device)
               for files in cams]
    finally:
        detect.shutdown()
    dev = torch.device(device)
    F64 = torch.float64
    visible = np.stack([v for _, v in det])
    prob = lm.Problem(
        models=[c["model"] for c in conf["rig"]["cameras"]],
        p_w=torch.as_tensor(truth.rig.target.circles_3d(), dtype=F64,
                            device=dev),
        pixels=torch.as_tensor(np.stack([p for p, _ in det]), dtype=F64,
                               device=dev),
        valid=torch.as_tensor(visible, dtype=F64, device=dev),
        frame_t=stamps[sel], imu_t=imu["timestamp"], imu_g=imu["gyro"],
        imu_a=imu["accel"])
    st, iters, cost = lm.solve(prob, _initial_state(truth, sel, dev),
                               log=log)
    if log:
        log("plain reference: %d frames, %d iterations, cost %.9e"
            % (len(sel), iters, cost))
    chunk = int(traffic.get("chunk") or 0)
    return _outputs(st, visible), (-(-len(sel) // chunk) if chunk else None)


def model_displacement_px(cam, params_ref, params, grid=16):
    """Widest distance between where the two models put the same rays,
    over a grid x grid set of pixels across camera ``cam``'s frame."""
    f64 = torch.float64
    us = np.linspace(0, cam.width - 1, grid)
    vs = np.linspace(0, cam.height - 1, grid)
    pix = torch.as_tensor(np.stack(np.meshgrid(us, vs), -1).reshape(-1, 2),
                          dtype=f64)
    k_ref = torch.as_tensor(np.asarray(params_ref, np.float64), dtype=f64)
    k = torch.as_tensor(np.asarray(params, np.float64), dtype=f64)
    if k.shape != k_ref.shape or not torch.isfinite(k).all():
        return float("inf")
    back = sim.project(cam.model, sim.unproject(cam.model, pix, k_ref), k)
    d = torch.linalg.norm(back - pix, dim=-1).max()
    return float(d) if torch.isfinite(d) else float("inf")


NUMBERS = ("intr_px", "extr", "gyro_bias", "accel_bias", "time_offset_s",
           "gravity_rad", "pose_m", "pose_rad", "missing_poses")


def compare(out, ref, rig):
    """Every number of a call's outputs ``out`` against ``ref`` (both as
    read_outputs gives them); what is missing reads as infinitely far."""
    inf = float("inf")
    nums = dict.fromkeys(NUMBERS, inf)
    if out is None or ref is None:
        return nums
    C = len(rig.cameras)
    if len(out["cams"]) == len(ref["cams"]) == C:
        nums["intr_px"] = max(model_displacement_px(c, pr, p) for c, (p, _),
                              (pr, _) in zip(rig.cameras, out["cams"],
                                             ref["cams"]))
        nums["extr"] = max(se3_error(T, Tr) for (_, T), (_, Tr)
                           in zip(out["cams"], ref["cams"]))
    a, b = out["bw_ba"], ref["bw_ba"]
    if a is not None and b is not None and a.shape == b.shape == (6,):
        nums["gyro_bias"] = float(np.abs(a[:3] - b[:3]).max())
        nums["accel_bias"] = float(np.abs(a[3:] - b[3:]).max())
    if out["ts"] is not None and ref["ts"] is not None:
        nums["time_offset_s"] = abs(out["ts"] - ref["ts"])
    a, b = out["G"], ref["G"]
    if a is not None and b is not None and a.shape == b.shape == (2,):
        g, gr = (sim.gravity(torch.as_tensor(x)).numpy() for x in (a, b))
        nums["gravity_rad"] = float(np.arctan2(
            np.linalg.norm(np.cross(g, gr)), np.dot(g, gr)))
    P, Pr = out["poses"], ref["poses"]
    nums["missing_poses"] = abs(len(Pr) - len(P))
    if len(P) == len(Pr) and len(P):
        pos, rot = [], []
        for row, row_r in zip(P, Pr):
            M, Mr = _cart_to_matrix(row), _cart_to_matrix(row_r)
            pos.append(np.linalg.norm(M[:3, 3] - Mr[:3, 3]))
            rot.append(rotation_angle(M[:3, :3].T @ Mr[:3, :3]))
        nums["pose_m"] = float(max(pos))
        nums["pose_rad"] = float(max(rot))
    return {k: (float(v) if np.isfinite(v) else inf)
            for k, v in nums.items()}


def compare_published(published, n_chunks):
    """The chunk estimates a live call published against the chunks its
    frames make."""
    return {"missing_chunks": float("inf") if n_chunks is None
            else abs(n_chunks - len(published))}


def judge(numbers, limits):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit is an error of the benchmark."""
    checks = {}
    ok = True
    for name in sorted(limits):
        if name not in numbers:
            raise KeyError("no number %r to compare" % name)
        v = numbers[name]
        checks[name] = {"value": v, "limit": limits[name]}
        ok = ok and v <= limits[name]
    return ok, checks
