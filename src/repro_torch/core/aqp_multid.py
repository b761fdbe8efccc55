"""Box predicates over joint KDE synopses (eq. 11).
Counterpart: `batch_query_box` in `repro/core/aqp_multid.py:89-141`; the
reference's plain per-query terms (`_box_terms`) are `kernels/ref.py`'s
`aqp_box_sums` here.

For diagonal bandwidths the box integral factorises into per-axis 1-D
closed forms:

  COUNT(box) ~= scale * sum_i  prod_j  [Phi]_ij
  SUM(t;box) ~= scale * sum_i  m_it * prod_{j!=t} [Phi]_ij,
                m_ij = X_ij [Phi]_ij - h_j [phi]_ij
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as kref

from .aqp import _select_op


def batch_query_box(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, tgt: torch.Tensor, ops: torch.Tensor,
                    scale: float, backend: str = "torch") -> torch.Tensor:
    """Answer a mixed box batch against one diagonal-bandwidth joint
    synopsis.  x: (n,d); lo/hi: (q,d); tgt/ops: (q,).  backend="cuda" runs
    the (queries x samples x dims) reduction in the aqp_boxes kernel,
    backend="torch" its plain version (`kernels/ref.py`)."""
    if backend == "cuda":
        from repro_torch.kernels import ops as kops
        cnt_raw, sum_raw = kops.aqp_box_sums(x, h_diag, lo, hi, tgt)
    else:
        cnt_raw, sum_raw = kref.aqp_box_sums(x, h_diag, lo, hi, tgt)
    return _select_op(ops, scale * cnt_raw, scale * sum_raw)
