"""Structured normal-equations solve: frame elimination via block-tridiagonal
factorization + dense reduced system over the shared parameters.

  H = [[A,  B ],      A: block-tridiagonal (F blocks of 9x9)
       [B', C ]]      C: dense (S x S), S ~ tens

Schur complement: S_red = C - B' A^-1 B, then a small dense Cholesky solve
and back-substitution.  A^-1 is applied by block cyclic reduction: O(log F)
levels of batched 9x9 solves instead of a 2F-step sequential block-Thomas
sweep.  Jacobi (diagonal) scaling is applied symmetrically before the solve.

A reduced system that is not positive definite yields NaN (``cholesky_ex``
with ``info != 0`` mapped to NaN, as JAX's cholesky returns NaN), so the LM
policy drops that damping candidate through ``pred > 0``.
"""
from __future__ import annotations

import math

import torch


def tridiag_solve_seq(D, U, B):
    """Solve the block-tridiagonal system A X = B by sequential
    block-Thomas.  Diagonal blocks ``D`` (F, n, n), super-diagonal ``U``
    (F-1, n, n), sub-diagonal U^T, right-hand sides B (F, n, R).  O(F)
    sequential depth: the test oracle for :func:`tridiag_solve`."""
    F = D.shape[0]
    Cs = [D[0]]
    Gs = [B[0]]
    for k in range(1, F):
        L = torch.linalg.solve(Cs[-1], U[k - 1]).transpose(0, 1)
        Cs.append(D[k] - L @ U[k - 1])
        Gs.append(B[k] - L @ Gs[-1])
    xs = [None] * F
    xs[-1] = torch.linalg.solve(Cs[-1], Gs[-1])
    for k in range(F - 2, -1, -1):
        xs[k] = torch.linalg.solve(Cs[k], Gs[k] - U[k] @ xs[k + 1])
    return torch.stack(xs)


def _spd_solve_small(A, B):
    """Batched SPD solve via a fully unrolled Cholesky (no pivoting).

    A: (..., n, n) SPD, B: (..., n, R).  Column-by-column elementwise ops
    over the batch; every block here is a damped, Jacobi-scaled
    Gauss-Newton diagonal block.
    """
    n = A.shape[-1]
    ar = torch.arange(n, device=A.device)
    cols = []                                   # L columns, each (..., n)
    for k in range(n):
        a_k = A[..., :, k]
        for j in range(k):
            a_k = a_k - cols[j] * cols[j][..., k:k + 1]
        d = torch.sqrt(torch.clamp(a_k[..., k], min=1e-30))
        col = a_k / d[..., None]
        col = torch.where(ar >= k, col, torch.zeros_like(col))
        cols.append(col)
    # forward substitution: L Y = B
    y = []
    for k in range(n):
        acc = B[..., k, :]
        for j in range(k):
            acc = acc - cols[j][..., k:k + 1] * y[j]
        y.append(acc / cols[k][..., k:k + 1])
    # back substitution: L^T X = Y
    x = [None] * n
    for k in reversed(range(n)):
        acc = y[k]
        for j in range(k + 1, n):
            acc = acc - cols[k][..., j:j + 1] * x[j]
        x[k] = acc / cols[k][..., k:k + 1]
    return torch.stack(x, dim=-2)


def _spd_solve_scaled(A, B):
    """Batched SPD solve: symmetrize, Jacobi-rescale to unit diagonal, then
    the unrolled Cholesky."""
    A = 0.5 * (A + A.transpose(-1, -2))
    d = torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), min=1e-30)
    s = 1.0 / torch.sqrt(d)                                  # (..., n)
    As = A * s[..., :, None] * s[..., None, :]
    Bs = B * s[..., :, None]
    return _spd_solve_small(As, Bs) * s[..., :, None]


def tridiag_solve(D, U, B):
    """Solve the block-tridiagonal system A X = B by block cyclic reduction.

    Same system as :func:`tridiag_solve_seq` with O(log F) depth: each level
    eliminates the odd rows with batched n x n solves, halving the system,
    then back-substitutes up the levels.  Rows are padded to a power of two
    with decoupled identity rows.
    """
    F, n, _ = D.shape
    R = B.shape[2]
    dtype, dev = D.dtype, D.device
    if F == 1:
        return torch.linalg.solve(D, B)

    zero1 = torch.zeros((1, n, n), dtype=dtype, device=dev)
    # row-local couplings: L[i] couples x_{i-1}, Rr[i] couples x_{i+1}
    L = torch.cat([zero1, U.transpose(1, 2)], dim=0)
    Rr = torch.cat([U, zero1], dim=0)

    Fp = 1 << (F - 1).bit_length()
    pad = Fp - F
    if pad:
        eye = torch.eye(n, dtype=dtype, device=dev).expand(pad, n, n)
        znn = torch.zeros((pad, n, n), dtype=dtype, device=dev)
        D = torch.cat([D, eye], dim=0)
        L = torch.cat([L, znn], dim=0)
        Rr = torch.cat([Rr, znn], dim=0)
        B = torch.cat([B, torch.zeros((pad, n, R), dtype=dtype,
                                      device=dev)], dim=0)

    def split(a):
        m = a.shape[0]
        a2 = a.reshape((m // 2, 2) + tuple(a.shape[1:]))
        return a2[:, 0], a2[:, 1]

    levels = []
    while D.shape[0] > 1:
        D_e, D_o = split(D)
        L_e, L_o = split(L)
        R_e, R_o = split(Rr)
        B_e, B_o = split(B)
        # one batched SPD solve for everything the odd rows contribute
        sol = _spd_solve_scaled(D_o, torch.cat([L_o, R_o, B_o], dim=2))
        DiL, DiR, DiB = sol[:, :, :n], sol[:, :, n:2 * n], sol[:, :, 2 * n:]
        levels.append((DiL, DiR, DiB))
        # odd row j-1 (global 2j-1) terms, shifted into kept-row alignment
        znn = torch.zeros((1, n, n), dtype=dtype, device=dev)
        DiL_m = torch.cat([znn, DiL[:-1]], dim=0)
        DiR_m = torch.cat([znn, DiR[:-1]], dim=0)
        DiB_m = torch.cat([torch.zeros((1, n, R), dtype=dtype, device=dev),
                           DiB[:-1]], dim=0)
        D = D_e - L_e @ DiR_m - R_e @ DiL
        B = B_e - L_e @ DiB_m - R_e @ DiB
        L, Rr = -(L_e @ DiL_m), -(R_e @ DiR)

    x = _spd_solve_scaled(D, B)
    for DiL, DiR, DiB in reversed(levels):
        x_e = x
        x_next = torch.cat([x_e[1:], torch.zeros((1, n, R), dtype=dtype,
                                                 device=dev)], dim=0)
        x_o = DiB - DiL @ x_e - DiR @ x_next
        # interleave evens/odds
        x = torch.stack([x_e, x_o], dim=1).reshape(-1, n, R)
    return x[:F]


def _cholesky_or_nan(A):
    """Lower Cholesky factor(s) of A (..., n, n), all NaN where a matrix is
    not positive definite."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, math.nan), L)


def schur_solve(D, U, Hfs, Hss, gf, gs, damping=0.0):
    """Solve H dx = -g for the arrow-plus-chain system.

    D: (F, 9, 9) frame diagonal blocks; U: (F-1, 9, 9) super-diagonal;
    Hfs: (F, 9, S); Hss: (S, S); gf: (F, 9); gs: (S,).  ``damping`` is the
    LM lambda: diagonal entries are scaled by (1 + lambda) with an absolute
    floor.  Returns (dx_f (F, 9), dx_s (S,), pred_red), where pred_red is
    the model-predicted cost reduction 0.5 (lambda dx' Ddiag dx - g' dx).
    """
    F, n, _ = D.shape
    S = Hss.shape[0]
    dtype, dev = D.dtype, D.device
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    eye_S = torch.eye(S, dtype=dtype, device=dev)
    floor = 1e-9

    d0f = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1), min=floor)
    d0s = torch.clamp(torch.diagonal(Hss), min=floor)
    g0f, g0s = gf, gs
    D = D + (damping * torch.diag_embed(d0f) + floor * eye_n)
    Hss = Hss + damping * torch.diag_embed(d0s) + floor * eye_S

    # Jacobi scaling for conditioning
    df = torch.diagonal(D, dim1=-2, dim2=-1)
    ds = torch.diagonal(Hss)
    sf = 1.0 / torch.sqrt(torch.clamp(df, min=1e-12))
    ss = 1.0 / torch.sqrt(torch.clamp(ds, min=1e-12))
    D = D * sf[:, :, None] * sf[:, None, :]
    U = U * sf[:-1][:, :, None] * sf[1:][:, None, :]
    Hfs = Hfs * sf[:, :, None] * ss[None, None, :]
    Hss = Hss * ss[:, None] * ss[None, :]
    gf = gf * sf
    gs = gs * ss

    # eliminate frames
    rhs = torch.cat([Hfs, gf[:, :, None]], dim=2)           # (F, 9, S+1)
    X = tridiag_solve(D, U, rhs)                            # A^-1 [B, gf]
    BtX = torch.einsum("fis,fit->st", Hfs, X)               # (S, S+1)
    S_red = Hss - BtX[:, :S]
    rhs_red = -gs + BtX[:, S]
    S_sym = 0.5 * (S_red + S_red.transpose(0, 1))
    chol = _cholesky_or_nan(S_sym)
    dx_s = torch.cholesky_solve(rhs_red[:, None], chol)[:, 0]
    dx_f = -X[:, :, S] - torch.einsum("fis,s->fi", X[:, :, :S], dx_s)
    dx_f = dx_f * sf
    dx_s = dx_s * ss

    # predicted model reduction in the original (unscaled) coordinates
    g_dot = torch.sum(g0f * dx_f) + torch.sum(g0s * dx_s)
    damp_quad = damping * (torch.sum(d0f * dx_f * dx_f)
                           + torch.sum(d0s * dx_s * dx_s))
    pred_red = 0.5 * (damp_quad - g_dot)
    return dx_f, dx_s, pred_red
