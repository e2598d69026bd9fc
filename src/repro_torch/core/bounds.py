"""Lower bounds for the absolute inner product |<x, q>| (paper Section IV).

All bounds work on the simplified P2HNNS problem: ``x`` carries the appended
1-coordinate and ``q`` is the rescaled hyperplane, so the P2H distance is
``|<x,q>|``.  Plain broadcasting tensor functions, shared by the DFS, the
sweep and the sweep kernel's plain version.

  * :func:`node_ball_bound`  -- Theorem 2
  * :func:`point_ball_bound` -- Corollary 1
  * :func:`point_cone_bound` -- Theorem 3
"""
from __future__ import annotations

import torch

__all__ = [
    "node_ball_bound",
    "point_ball_bound",
    "query_angle_terms",
    "point_cone_bound",
]


def node_ball_bound(ip_qc, q_norm, radius):
    """Theorem 2: ``min_{x in N} |<x,q>| >= max(|<q,N.c>| - ||q||*N.r, 0)``."""
    return torch.clamp(torch.abs(ip_qc) - q_norm * radius, min=0.0)


def point_ball_bound(ip_qc, q_norm, r_x):
    """Corollary 1: Theorem 2 with the per-point radius ``r_x = ||x-N.c||``
    and the *leaf* center inner product ``ip_qc``."""
    return torch.clamp(torch.abs(ip_qc) - q_norm * r_x, min=0.0)


def query_angle_terms(ip_qc, q_norm, c_norm, eps=1e-12):
    """``(q_cos, q_sin) = (||q|| cos(theta), ||q|| sin(theta))`` for the angle
    ``theta`` between ``q`` and the leaf center, from ``<q, N.c>``."""
    c_norm = torch.clamp(torch.as_tensor(c_norm), min=eps)
    q_cos = ip_qc / c_norm
    q_sin = torch.sqrt(torch.clamp(q_norm * q_norm - q_cos * q_cos, min=0.0))
    return q_cos, q_sin


def _cone_cases(q_cos, q_sin, x_cos, x_sin):
    """RHS of Inequality 10 for a fixed sign of q.

      a = ||x|| ||q|| cos(theta + phi_x) = q_cos*x_cos - q_sin*x_sin
      b = ||x|| ||q|| cos(theta - phi_x) = q_cos*x_cos + q_sin*x_sin
    """
    a = q_cos * x_cos - q_sin * x_sin
    b = q_cos * x_cos + q_sin * x_sin
    zero = torch.zeros_like(a)
    # Theorem 3, in this order: case (a) needs cos(theta+phi) > 0 and
    # cos(theta) > 0 and cos(phi) > 0; else case (b) needs cos(theta-phi) < 0;
    # else the cone may hold a direction orthogonal to q -> bound 0
    return torch.where((a > 0) & (q_cos > 0) & (x_cos > 0), a,
                       torch.where(b < 0, -b, zero))


def point_cone_bound(q_cos, q_sin, x_cos, x_sin, symmetric: bool = False):
    """Theorem 3: point-level cone bound.

    ``symmetric=True`` also evaluates the bound for ``-q`` (the same
    quantity, since ``|<x,-q>| = |<x,q>|``) and takes the max.
    """
    lb = _cone_cases(q_cos, q_sin, x_cos, x_sin)
    if symmetric:
        lb = torch.maximum(lb, _cone_cases(-q_cos, q_sin, x_cos, x_sin))
    return lb
