"""IMU residual whitening from covariance propagation (UpdateImuWeights).

Pure function of (state, imu factors, sigmas), so the LM loop can recompute
it on the device every few iterations (reference: vicalibrator.h:690-692,
723-799).
"""
from __future__ import annotations

import torch
from torch.func import jacrev, vmap

from ..geometry import se3
from ..imu import preintegrate
from .problem import CalibState
from .residuals import ImuFactors
from .schur import _cholesky_or_nan

# IMU measurement sigmas (types.h:34-35), overridable by flags
IMU_GYRO_SIGMA = 5.3088444e-5
IMU_ACCEL_SIGMA = 0.001883649


def imu_weights(state: CalibState, imu: ImuFactors,
                gyro_sigma=IMU_GYRO_SIGMA, accel_sigma=IMU_ACCEL_SIGMA):
    """(K, 9, 9) whitening weights.

    cov10 = J_g Sigma_g J_g^T + J_a Sigma_a J_a^T with J the autodiff
    Jacobian of the integrated end-state w.r.t. the window's raw samples;
    transformed through the residual map [log(T_end T_2^-1); v_end - v2];
    weight = W with W^T W = (cov9)^-1, the inverse Cholesky factor
    (vicalibrator.h:747-796 takes the symmetric square root; |W r|^2, the
    normal equations and the Mahalanobis diagnostic are the same).
    accel_sigma^2 is factored out so the factorization sees O(1) entries.
    The propagation is vmapped over factors; the (K, 9, 9) Cholesky and the
    triangular inverse run batched after it.
    """
    fi = imu.frame_i
    q1s, t1s, v1s = state.q_wk[fi], state.t_wk[fi], state.v_w[fi]
    q2s, t2s, v2s = (state.q_wk[fi + 1], state.t_wk[fi + 1],
                     state.v_w[fi + 1])
    ratio2 = (gyro_sigma / accel_sigma) ** 2

    def one(k_q1, k_t1, k_v1, k_q2, k_t2, k_v2, wtk, wgk, wak, t_start,
            t_end):
        def endstate(gyro_vals, accel_vals):
            return preintegrate.end_state(
                (k_q1, k_t1), k_v1, wtk, gyro_vals, accel_vals, t_start,
                t_end, state.g_dir, state.biases[:3], state.biases[3:],
                state.scales, state.time_offset)

        y = endstate(wgk, wak)
        Jg, Ja = jacrev(endstate, argnums=(0, 1))(wgk, wak)
        M = wtk.shape[0]
        Jg = Jg.reshape(10, 3 * M)
        Ja = Ja.reshape(10, 3 * M)
        cov10 = ratio2 * (Jg @ Jg.T) + (Ja @ Ja.T)

        def res_of_y(y10):
            T_end = (y10[3:7] / torch.linalg.norm(y10[3:7]), y10[0:3])
            d = se3.mul(T_end, se3.inverse((k_q2, k_t2)))
            return torch.cat([se3.log(d), y10[7:10] - k_v2])

        Dmap = jacrev(res_of_y)(y)
        M9 = Dmap @ cov10 @ Dmap.T
        eye9 = torch.eye(9, dtype=M9.dtype, device=M9.device)
        M9 = 0.5 * (M9 + M9.T) + eye9 * 1e-12
        # unit-diagonal scaling makes the entries O(1); a relative jitter
        # keeps the unpivoted Cholesky finite on the float32 path
        d = torch.clamp(torch.diagonal(M9), min=1e-20)
        dscale = 1.0 / torch.sqrt(d)
        eps = 1e-6 if M9.dtype == torch.float32 else 1e-12
        return (M9 * dscale[:, None] * dscale[None, :] + eye9 * eps,
                dscale)

    M9s, dscale = vmap(one)(q1s, t1s, v1s, q2s, t2s, v2s, imu.win_times,
                            imu.win_gyro, imu.win_accel, imu.start, imu.end)
    eye9 = torch.eye(9, dtype=M9s.dtype, device=M9s.device)
    L = _cholesky_or_nan(M9s)
    inv_L = torch.linalg.solve_triangular(L, eye9.expand_as(L), upper=False)
    inv_sqrt = (inv_L * dscale[:, None, :]) / accel_sigma
    # a numerically non-PD factor (Cholesky NaN) or one without
    # measurements falls back to the I*500 seed weight rather than
    # poisoning the whole stage
    finite = torch.isfinite(inv_sqrt)
    ok = imu.has_meas & torch.all(finite.flatten(1), dim=1)
    return torch.where(ok[:, None, None],
                       torch.where(finite, inv_sqrt,
                                   torch.zeros_like(inv_sqrt)),
                       eye9 * 500.0)
