from .assemble import ProblemData, assemble, robust_costs  # noqa: F401
from .lm import LMInfo, LMOptions, LMSolver  # noqa: F401
from .problem import (  # noqa: F401
    CalibState, SharedLayout, StageFlags, frame_mask, init_state, retract,
    shared_mask,
)
from .residuals import CameraObs, ImuFactors  # noqa: F401
from .robust import Cauchy, SoftL1, Trivial  # noqa: F401
from .schur import schur_solve, tridiag_solve  # noqa: F401
from .stages import (  # noqa: F401
    StagedResult, initialize_gravity, run_staged,
)
from .weights import imu_weights  # noqa: F401
