"""Convolutions and pools (counterpart of ``graphflow_tpu/ops/conv.py``).

The layout is the reference's Tensor3D: images [H, W, C] (depth last) or a
batch [N, H, W, C], 2-D filters [KH, KW, C1, C2] (HWIO), 1-D inputs
[L, C1] or [N, L, C1] with filters [K, C1, C2].  Each function permutes to
torch's NCHW/OIHW, runs the torch op and permutes back.  The JAX package
runs these as XLA ops and no Pallas kernel; here they are torch ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, filt: torch.Tensor, bias=None, stride: int = 1,
           pad: int = 0) -> torch.Tensor:
    """``Conv2D.h:39-89``: 2-D cross-correlation with a symmetric zero pad
    and a stride.  ``bias`` [C1, C2]: the reference adds
    ``sum_{c1} bias[c1, c2]`` to every output pixel (``Conv2D.h:76-86``).
    A bias of another rank raises, as in the JAX package."""
    if bias is not None and bias.dim() != 2:
        raise ValueError(f"conv2d takes a bias [C1, C2], got shape "
                         f"{tuple(bias.shape)}")
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    out = F.conv2d(x.permute(0, 3, 1, 2), filt.permute(3, 2, 0, 1),
                   stride=stride, padding=pad).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.sum(dim=0)
    return out[0] if squeeze else out


def conv1d(x: torch.Tensor, filt: torch.Tensor, bias=None, stride: int = 1,
           pad: int = 0) -> torch.Tensor:
    """``Conv1D.h``: 1-D cross-correlation.  ``bias`` [C2], or [C1, C2]
    summed over C1 as in :func:`conv2d`."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    out = F.conv1d(x.permute(0, 2, 1), filt.permute(2, 1, 0), stride=stride,
                   padding=pad).permute(0, 2, 1)
    if bias is not None:
        out = out + (bias.sum(dim=0) if bias.dim() == 2 else bias)
    return out[0] if squeeze else out


def _pool(fn, x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    out = fn(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)
    return out[0] if squeeze else out


def max_pool2d(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """``MaxPool2D.h:33-63``: VALID max pooling."""
    return _pool(F.max_pool2d, x, window, stride)


def avg_pool2d(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """``AveragePool2D.h``: VALID average pooling, each window's sum over
    window * window."""
    return _pool(F.avg_pool2d, x, window, stride)
