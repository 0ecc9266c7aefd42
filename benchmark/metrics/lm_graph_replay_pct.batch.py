"""Share of the LM iterations of a batch calibration whose step ran as a
CUDA graph replay, in %: 100 x the program's counter
``vicalib.lm.graph_replay`` (its ``count`` row) over n(``vicalib.lm.iter``)
(its ``span`` row), per untraced call's result log.  A log without the
counter, as from a program that replays nothing, reads as nothing."""
import os
import re

from harness.readers import untraced
from harness.spans import spans

_COUNT = re.compile(r"^count vicalib\.lm\.graph_replay: (\d+)$", re.M)


def read(rec):
    vals = []
    for c in untraced(rec):
        try:
            with open(os.path.join(c["out"], "vicalibrator.log")) as f:
                m = _COUNT.search(f.read())
        except OSError:
            continue
        n = spans(c).get("vicalib.lm.iter", (0, 0.0))[0]
        if m and n:
            vals.append(100.0 * int(m.group(1)) / n)
    return sum(vals) / len(vals) if vals else None
