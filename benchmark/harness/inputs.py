"""The files a user hands the program, made from the seed: one directory of
PGM frames with a timestamps.txt per camera, and the IMU as accel.txt,
gyro.txt and timestamp.txt (the ``csv://`` layout)."""
from __future__ import annotations

import os

import numpy as np
import torch

from . import sim


def write_pgm(path, img):
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(np.ascontiguousarray(img, dtype=np.uint8).tobytes())


def write_rig(conf, seed, root, device, n_frames=None):
    """Simulate the configuration's rig from ``seed``, render every camera
    on ``device`` and write the files under ``root``.  Returns the truth and
    the paths ({"cams": [dir, ...], "imu": dir})."""
    rig = sim.rig_from_config(conf, n_frames)
    truth = sim.simulate(rig, seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    cams = []
    for c in range(len(rig.cameras)):
        d = os.path.join(root, "cam%d" % c)
        os.makedirs(d)
        for k, img in enumerate(sim.render(truth, c, gen, device)):
            write_pgm(os.path.join(d, "f%05d.pgm" % k), img)
        np.savetxt(os.path.join(d, "timestamps.txt"), truth.frame_times)
        cams.append(d)
    imu = os.path.join(root, "imu")
    os.makedirs(imu)
    np.savetxt(os.path.join(imu, "accel.txt"), truth.accel)
    np.savetxt(os.path.join(imu, "gyro.txt"), truth.gyro)
    np.savetxt(os.path.join(imu, "timestamp.txt"), truth.imu_times)
    return truth, {"cams": cams, "imu": imu}
