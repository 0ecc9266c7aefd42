"""Standalone target tracker — the reference's second executable.

Reference analog: src/tracker.cc:36-130 (``tracker`` binary): per frame,
detect the grid, estimate the target-from-camera pose and print T_gw; the
GUI trail is replaced by optional poses output (headless).

Each frame is detected on the device with the threshold + labelling kernel
(a batch of one), associated with the grid on the host, and its pose comes
from planar PnP (deterministic, no RANSAC) on the device.  Runs on the CUDA
device unless the caller passes ``device="cpu"``.

Usage:
  python -m vicalib_tpu_torch.tracker -cam 'file://<dir>/*.pgm'
      [-models linear] [-grid_preset medium] [-output_poses poses.txt]
"""
from __future__ import annotations

import argparse
import logging
import sys

import numpy as np
import torch

log = logging.getLogger("vicalib_tpu_torch.tracker")


def main(argv=None, device="cuda") -> int:
    p = argparse.ArgumentParser(prog="tracker")
    p.add_argument("--cam", "-cam", required=True)
    p.add_argument("--models", "-models", default="linear")
    p.add_argument("--model_files", "-model_files", default="")
    p.add_argument("--grid_preset", "-grid_preset", default="")
    p.add_argument("--grid_height", "-grid_height", type=int, default=10)
    p.add_argument("--grid_width", "-grid_width", type=int, default=19)
    p.add_argument("--grid_spacing", "-grid_spacing", type=float,
                   default=0.01355)
    p.add_argument("--grid_seed", "-grid_seed", type=int, default=71)
    p.add_argument("--output_poses", "-output_poses", default="")
    ns = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname).1s %(name)s: %(message)s")

    from .cameras import get_model
    from .detect import pnp
    from .detect.conics import ConicParams, find_conics
    from .device import resolve_device
    from .geometry import quat_np
    from .io import outputs as out_io
    from .io import sources
    from .targets import grid as grid_mod
    from .targets.grid_match import match_target

    dev = resolve_device(device)
    camera = sources.parse_camera_uri(ns.cam)
    if ns.grid_preset:
        target = grid_mod.load_preset(ns.grid_preset)
    else:
        target = grid_mod.TargetGrid(
            grid_mod.make_pattern(ns.grid_height, ns.grid_width,
                                  ns.grid_seed), ns.grid_spacing)

    if ns.model_files:
        cam_info = out_io.read_cameras_xml(ns.model_files.split(",")[0])[0]
        model = get_model(cam_info["model"])
        params = torch.as_tensor(np.asarray(cam_info["params"]),
                                 dtype=torch.float64, device=dev)
    else:
        model = get_model(ns.models.split(",")[0])
        h, w = camera.read_batch(0, [0])[0].shape
        params = model.init_params(w, h, dtype=torch.float32, device=dev)

    stamps = camera.channel_stamps(0)
    p3d_xy = torch.as_tensor(target.circles_3d()[:, :2], dtype=torch.float64,
                             device=dev)
    rows = []
    n_tracked = 0
    for k in range(camera.n_frames):
        t = float(stamps[k])
        img = camera.read_batch(0, [k])[0]
        det = find_conics(torch.from_numpy(np.ascontiguousarray(img)),
                          ConicParams(max_conics=512), device=dev)
        center = det["center"].cpu().numpy()
        m = match_target(center, det["radius"].cpu().numpy(),
                         det["valid"].cpu().numpy(), target)
        if not m.ok:
            log.info("frame %d: tracking lost", k)
            continue
        sel = m.grid_coords[:, 0] >= 0
        gidx = (m.grid_coords[sel, 1] * target.cols + m.grid_coords[sel, 0])
        rays = model.unproject(torch.as_tensor(center[sel], device=dev),
                               params)[:, :2]
        full_rays = torch.zeros((target.n_points, 2), dtype=torch.float64,
                                device=dev)
        full_rays[torch.as_tensor(gidx, device=dev)] = rays.to(torch.float64)
        valid = np.zeros(target.n_points)
        valid[gidx] = 1.0
        q_cw, t_cw = pnp.pnp_planar(full_rays, p3d_xy,
                                    torch.as_tensor(valid, device=dev))
        n_tracked += 1
        # T_gw == T_cw here (grid frame is the world frame)
        T = np.eye(4)
        T[:3, :3] = quat_np.to_matrix(q_cw.cpu().numpy())
        T[:3, 3] = t_cw.cpu().numpy()
        print(f"frame {k} t={t:.6f} tracked {int(sel.sum())} dots; T_gw =")
        np.savetxt(sys.stdout, T, fmt="%+.6f")
        rows.append(out_io.t2cart(T))
    if ns.output_poses and rows:
        np.savetxt(ns.output_poses, np.stack(rows), delimiter="\t", fmt="%f")
        log.info("wrote %s (%d poses)", ns.output_poses, len(rows))
    log.info("tracked %d/%d frames", n_tracked, camera.n_frames)
    return 0 if n_tracked else 1


if __name__ == "__main__":
    sys.exit(main())
