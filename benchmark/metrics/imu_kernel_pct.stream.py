"""Share of the IMU factor evaluations of a live calibration (every
chunk's re-solve) that the CUDA kernel made, in %: 100 x the program's
counter ``vicalib.imu.kernel_factors`` over ``vicalib.imu.factors``
(their ``count`` rows), per untraced call's result log, averaged.  A log
without ``vicalib.imu.factors``, as from a program that counts no
factors, reads as nothing; one without ``vicalib.imu.kernel_factors``
reads 0."""
import os
import re

from harness.readers import untraced

_COUNT = re.compile(r"^count vicalib\.imu\.(kernel_factors|factors): (\d+)$",
                    re.M)


def read(rec):
    vals = []
    for c in untraced(rec):
        try:
            with open(os.path.join(c["out"], "vicalibrator.log")) as f:
                counts = {k: int(n) for k, n in _COUNT.findall(f.read())}
        except OSError:
            continue
        if counts.get("factors"):
            vals.append(100.0 * counts.get("kernel_factors", 0)
                        / counts["factors"])
    return sum(vals) / len(vals) if vals else None
