"""Robust loss functions (Ceres-equivalent) and IRLS weighting.

The reference wraps reprojection residuals in SoftLOneLoss(0.5) and IMU
residuals in CauchyLoss(100) (vicalibrator.h:127, 1073).  Ceres losses are
defined on the *squared* norm s = |r|^2:

  SoftLOne(a):  rho(s) = 2 b (sqrt(1 + s/b) - 1),  b = a^2
  Cauchy(a):    rho(s) = b log(1 + s/b),           b = a^2

Gauss-Newton handles them by IRLS: each residual block is scaled by
sqrt(rho'(s)) when building the normal equations, and the true robust cost
sum(rho(s))/2-convention matches Ceres (cost = 1/2 sum rho(s))."""
from __future__ import annotations

import torch


class SoftL1:
    def __init__(self, a=0.5):
        self.b = a * a

    def rho(self, s):
        return 2.0 * self.b * (torch.sqrt(1.0 + s / self.b) - 1.0)

    def weight(self, s):
        """sqrt(rho'(s)) — IRLS scale for the residual and its jacobian."""
        return (1.0 + s / self.b) ** -0.25


class Cauchy:
    def __init__(self, a=100.0):
        self.b = a * a

    def rho(self, s):
        return self.b * torch.log1p(s / self.b)

    def weight(self, s):
        return (1.0 + s / self.b) ** -0.5


class Trivial:
    def rho(self, s):
        return s

    def weight(self, s):
        return torch.ones_like(s)
