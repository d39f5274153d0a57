"""The optimizer step shared by the autodiff fitting loops.

Port of :mod:`dexct_tpu.utils.optim`: one Adam update with bias
correction, used by the one-step spectral fit
(:mod:`dexct_tpu_torch.ops.onestep`).
"""

from __future__ import annotations

import torch

__all__ = ["adam_step"]


def adam_step(p, g, m, v, i, lr, *, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam update with bias correction.

    p, g, m, v: parameter, gradient, first and second moment (same shape);
    i: 0-based iteration counter (float or int scalar); lr: step size.
    Returns (p_new, m_new, v_new).
    """
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    mh = m / (1.0 - b1 ** (i + 1.0))
    vh = v / (1.0 - b2 ** (i + 1.0))
    return p - lr * mh / (torch.sqrt(vh) + eps), m, v
