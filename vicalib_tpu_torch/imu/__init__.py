from .buffer import ImuBuffer, build_windows, gather_windows  # noqa: F401
from .preintegrate import (  # noqa: F401
    GRAVITY_MAG, end_state, gravity_vector, imu_factor_residual,
    integrate_sequence, virtual_sequence,
)
