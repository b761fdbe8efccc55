"""Rule-of-thumb bandwidth.  Counterpart: `silverman_h` in
`repro/core/kde.py`; the KDE evaluators there wait for the full-H slice."""
from __future__ import annotations

import torch


def silverman_h(x: torch.Tensor) -> torch.Tensor:
    """Rule-of-thumb bandwidth (paper §2.3 'first class' selector), 1-D."""
    n = x.shape[0]
    std = torch.std(x, correction=1)
    iqr = torch.quantile(x, 0.75) - torch.quantile(x, 0.25)
    a = torch.minimum(std, iqr / 1.349)
    return 0.9 * a * n ** (-0.2)
