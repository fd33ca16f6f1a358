"""Exact scores and top-k over a library, in float64: each bfloat16 row
widened exactly, ties ranked by row number (score descending, row
ascending)."""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 1 << 17


def topk(rows: torch.Tensor, queries: torch.Tensor, k: int):
    """The exact top ``k`` of each query over ``rows`` ((N, d), on the
    queries' device), block by block. Returns numpy (scores (Q, k)
    float64, rows (Q, k) int64)."""
    q = queries.double()
    parts_s, parts_i = [], []
    for start in range(0, rows.shape[0], BLOCK):
        s = q @ rows[start : start + BLOCK].double().T
        top_s, top_i = torch.sort(s, dim=1, descending=True, stable=True)
        kk = min(k, s.shape[1])
        parts_s.append(top_s[:, :kk].cpu())
        parts_i.append(top_i[:, :kk].cpu() + start)
    cs, ci = torch.cat(parts_s, 1).numpy(), torch.cat(parts_i, 1).numpy()
    order = np.lexsort((ci, -cs))[:, :k]
    return np.take_along_axis(cs, order, 1), np.take_along_axis(ci, order, 1)


def scores(rows: torch.Tensor, query: torch.Tensor, ids) -> np.ndarray:
    """float64 scores of one query against the rows ``ids``."""
    idx = torch.as_tensor(np.asarray(ids), device=rows.device)
    return (rows[idx].double() @ query.double()).cpu().numpy()
