"""The PageRank LP's own answer. Its one feasible point is the PageRank
vector, x = d S x + (1 - d)/n with sum(x) = 1, and y = 0 is a dual
optimum (the objective is 0). The reference works x out by the power
iteration from the LP's matrix, in f64 unless asked otherwise."""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import torch

from ..lp import Lp

TOL = 1e-10  # the f64 vector's l1 error is at most 2 d^k <= 2 TOL


def transition(lp: Lp, damping: float) -> sp.csr_matrix:
    """S from A = [sqrt(n) 1'; I - d S]."""
    lower = lp.constraint_matrix[1:]
    n = lower.shape[1]
    return ((sp.identity(n, format="csr") - lower) / damping).tocsr()


def power_iteration(s: sp.csr_matrix, damping: float, dtype, device,
                    tol: float = TOL) -> np.ndarray:
    """x <- d S x + (1 - d)/n from the uniform vector, S and x rounded to
    `dtype` before each product, the products and sums in f32 (f64 for
    f64); as many steps as d^k <= tol asks."""
    n = s.shape[0]
    steps = int(math.ceil(math.log(tol) / math.log(damping)))
    acc = torch.promote_types(dtype, torch.float32)
    vals = torch.as_tensor(s.data, device=device).to(dtype).to(acc)
    mat = torch.sparse_csr_tensor(
        torch.as_tensor(s.indptr, device=device),
        torch.as_tensor(s.indices, device=device), vals, size=s.shape)
    x = torch.full((n,), 1.0 / n, dtype=acc, device=device)
    for _ in range(steps):
        x = damping * (mat @ x.to(dtype).to(acc)) + (1.0 - damping) / n
    return x.double().cpu().numpy()


def solution(lp: Lp, damping: float, device="cpu") -> np.ndarray:
    """The PageRank vector of `lp` in f64."""
    return power_iteration(transition(lp, damping), damping,
                           torch.float64, device)
