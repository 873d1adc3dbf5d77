"""Carry the JAX package's band-engine state into the port.

Each function takes the JAX package's object (or any object with the
same fields) whose arrays convert with ``np.asarray``, and returns the
port's counterpart with its tensors on ``device``. Nothing here imports
the JAX package: its objects are read by field name. The tests use
these to feed the SAME band and factor to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.band import BandLevel, BandMatrix, FineLayout
from .ops.blocktri import BTFactor


def tensor(a, device="cpu") -> torch.Tensor:
    """A numpy-convertible array as a tensor on ``device``; bfloat16
    arrays (which numpy holds as the ml_dtypes type) keep their bits."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(arr), device=device)


def band_matrix(bm, device="cpu") -> BandMatrix:
    """BandMatrix (dense band + shift0/cchunk/ncols)."""
    return BandMatrix(dense=tensor(bm.dense, device), shift0=int(bm.shift0),
                      cchunk=int(bm.cchunk), ncols=int(bm.ncols))


def fine_layout(lay) -> FineLayout:
    """FineLayout (host slot maps; plain numpy on both sides)."""
    return FineLayout(*[np.asarray(f) if isinstance(f, np.ndarray) else f
                        for f in lay])


def band_level(lv, device="cpu") -> BandLevel:
    """The fine BandLevel: its band and inverse diagonal."""
    return BandLevel(A=band_matrix(lv.A, device),
                     invd=tensor(lv.invd, device).float())


def bt_factor(f, device="cpu") -> BTFactor:
    """BTFactor (Sinv, G, s)."""
    return BTFactor(Sinv=tensor(f.Sinv, device), G=tensor(f.G, device),
                    s=tensor(f.s, device).float())
