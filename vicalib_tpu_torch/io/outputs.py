"""Result serialization: cameras.xml, poses.txt, poses.csv, conics.csv.

Reference analogs:
- cameras.xml via WriteCameraModels with RDF baking
  (vicalibrator.h:208-229): with -calibrate_imu the camera pose is
  ``T_ck^-1 * SE3(RdfRobotics^-1, 0)`` under RDF=RdfRobotics, else
  ``T_ck^-1`` under RDF=RdfVision (identity).
- poses.txt: per-frame [x y z roll pitch yaw] rows from _T2Cart
  (vicalib-engine.cc:323-372).
- poses.csv: top-3x4 rows of each T_wk, row major (vicalib-engine.cc:409-422).
- conics.csv: frame, grid-id, u, v, x, y, z rows (vicalib-task.cc:306-318).
"""
from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from ..cameras import get_model
from ..geometry import quat_np

RDF_VISION = np.eye(3)
RDF_ROBOTICS = np.array([[0.0, 1.0, 0.0],
                         [0.0, 0.0, 1.0],
                         [1.0, 0.0, 0.0]])


def _pose_matrix(q, t):
    T = np.eye(4)
    T[:3, :3] = quat_np.to_matrix(np.asarray(q))
    T[:3, 3] = np.asarray(t)
    return T


def _fmt_mat(M):
    rows = ["[ " + "; ".join(", ".join(f"{v:.12g}" for v in row)
                             for row in M) + " ]"]
    return rows[0]


def _parse_mat(text, shape):
    vals = [float(v) for v in
            text.replace("[", " ").replace("]", " ").replace(";", " ")
            .replace(",", " ").split()]
    return np.asarray(vals).reshape(shape)


def write_cameras_xml(path, model_names, intrinsics, T_ck_list, widths,
                      heights, serials=None, calibrate_imu=True):
    """Write the calibu-style cameras.xml rig file."""
    rig = ET.Element("rig")
    for i, name in enumerate(model_names):
        model = get_model(name)
        cam_el = ET.SubElement(rig, "camera")
        cm = ET.SubElement(cam_el, "camera_model")
        cm.set("name", "")
        cm.set("index", str(i))
        cm.set("serialno", str(serials[i] if serials else -1))
        cm.set("type", model.type_string)
        cm.set("version", "8")
        ET.SubElement(cm, "width").text = str(int(widths[i]))
        ET.SubElement(cm, "height").text = str(int(heights[i]))
        q, t = T_ck_list[i]
        q = np.asarray(q)
        t = np.asarray(t)
        # T_wc = T_ck^-1 (vision RDF) or T_ck^-1 * SE3(RdfRobotics^-1, 0)
        qi, ti = quat_np.se3_inverse((q, t))
        if calibrate_imu:
            rdf = RDF_ROBOTICS
            q_r = quat_np.from_matrix(np.linalg.inv(RDF_ROBOTICS))
            qi, ti = quat_np.se3_mul((qi, ti), (q_r, np.zeros(3)))
        else:
            rdf = RDF_VISION
        ET.SubElement(cm, "RDF").text = _fmt_mat(rdf)
        params = np.asarray(intrinsics[i])[:model.n_params]
        ET.SubElement(cm, "params").text = _fmt_mat(params.reshape(1, -1))
        pose_el = ET.SubElement(cam_el, "pose")
        ET.SubElement(pose_el, "T_wc").text = _fmt_mat(
            _pose_matrix(qi, ti)[:3, :])
    tree = ET.ElementTree(rig)
    ET.indent(tree)
    tree.write(path, xml_declaration=True, encoding="unicode")


def read_cameras_xml(path):
    """Read a cameras.xml rig: returns list of dicts with model/params/T_wc.

    Reference analog: calibu::ReadXmlRig feeding -model_files preloads
    (vicalib-engine.cc:189-196).
    """
    tree = ET.parse(path)
    root = tree.getroot()
    cams = []
    for cam_el in root.findall("camera"):
        cm = cam_el.find("camera_model")
        type_str = cm.get("type")
        from ..cameras.models import TYPE_STRING_TO_NAME
        name = TYPE_STRING_TO_NAME.get(type_str)
        if name is None:
            raise ValueError(f"unknown camera model type {type_str!r}")
        model = get_model(name)
        params = _parse_mat(cm.find("params").text,
                            (model.n_params,))
        width = int(cm.find("width").text)
        height = int(cm.find("height").text)
        rdf = _parse_mat(cm.find("RDF").text, (3, 3))
        pose_el = cam_el.find("pose")
        T_wc = None
        if pose_el is not None and pose_el.find("T_wc") is not None:
            T_wc = _parse_mat(pose_el.find("T_wc").text, (3, 4))
        cams.append({
            "model": name, "params": params, "width": width,
            "height": height, "rdf": rdf, "T_wc": T_wc,
            "serial": cm.get("serialno"),
        })
    return cams


def t2cart(T):
    """4x4 -> [x, y, z, roll, pitch, yaw] (reference _T2Cart,
    vicalib-engine.cc:323-353)."""
    R = T[:3, :3]
    roll = np.arctan2(R[2, 1], R[2, 2])
    det = -R[2, 0] * R[2, 0] + 1.0
    if det <= 0:
        pitch = -np.pi / 2.0 if R[2, 0] > 0 else np.pi / 2.0
    else:
        pitch = -np.arcsin(R[2, 0])
    yaw = np.arctan2(R[1, 0], R[0, 0])
    return np.array([T[0, 3], T[1, 3], T[2, 3], roll, pitch, yaw])


def write_poses_txt(path, q_wk, t_wk, good=None):
    """poses.txt: tab-separated cart rows for good frames
    (vicalib-engine.cc:357-372)."""
    q_wk = np.asarray(q_wk)
    t_wk = np.asarray(t_wk)
    with open(path, "w") as f:
        for k in range(len(q_wk)):
            if good is not None and not good[k]:
                continue
            pose = t2cart(_pose_matrix(q_wk[k], t_wk[k]))
            f.write("\t".join(f"{v:f}" for v in pose) + "\n")


def write_poses_csv(path, q_wk, t_wk):
    """poses.csv: 12 elements of the top 3 rows of each T_wk
    (vicalib-engine.cc:409-422)."""
    q_wk = np.asarray(q_wk)
    t_wk = np.asarray(t_wk)
    with open(path, "w") as f:
        f.write("% Pose file generated with vicalib.\n")
        f.write("% Each line is the 12 elements from the top 3 rows of a 4x4"
                "transformation matrix, printed row major.\n")
        for k in range(len(q_wk)):
            T = _pose_matrix(q_wk[k], t_wk[k])
            f.write("     ".join(
                " ".join(f"{v:g}" for v in T[r]) for r in range(3)) + "\n")


def write_conics_csv(path, rows):
    """conics.csv rows: (frame, grid_id, u, v, x, y, z)
    (vicalib-task.cc:306-318)."""
    with open(path, "w") as f:
        for r in rows:
            f.write(",".join(str(v) for v in r) + "\n")
