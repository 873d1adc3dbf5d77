"""The parts' communicator: N parts as the leading axis of tensors.

The JAX package runs each part of a domain decomposition on its own
device inside ``shard_map`` and joins them with three collectives:
``ppermute`` (the ring halo exchange), ``psum`` (dot products) and
``all_gather`` (the sidecar's and the coarse solve's global vector).
Here every part's state is one slice ``x[p]`` of a tensor whose leading
axis counts the parts, all on one device, and the three operations are
tensor operations on that axis:

- ``ring_shift``: part d receives part d-1's strip (``step=+1``) or part
  d+1's (``step=-1``); the part at the open end of the ring receives
  zeros, as the JAX code masks it (``halo.py``'s ``jnp.where(me == 0,
  0.0, halo)``);
- ``psum``: the sum over the parts, added in part order, so the result
  does not depend on a reduction tree;
- ``all_gather``: the parts' pieces as one vector, part-major.

Each part's arithmetic is written as the JAX per-device body, with one
more leading axis. A communicator over several cards (NCCL through
``torch.distributed``) is not written (ROADMAP C.17).
"""

from __future__ import annotations

import torch


def ring_shift(x: torch.Tensor, step: int) -> torch.Tensor:
    """``x`` (P, ...) shifted one part along the ring: out[d] = x[d - step],
    zeros for the part whose sender would wrap around (part 0 for
    ``step=+1``, part P-1 for ``step=-1``)."""
    if step not in (1, -1):
        raise ValueError(f"ring_shift: step {step} (one part, +1 or -1)")
    out = torch.roll(x, step, dims=0)
    edge = 0 if step == 1 else x.shape[0] - 1
    keep = torch.arange(x.shape[0], device=x.device) != edge
    return torch.where(keep.view((-1,) + (1,) * (x.dim() - 1)), out,
                       torch.zeros_like(out))


def psum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` (P, ...) over its parts, added in part order."""
    acc = x[0]
    for p in range(1, x.shape[0]):
        acc = acc + x[p]
    return acc


def pdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The global dot product of two (P, n) part vectors: each part's
    own dot product, then ``psum``."""
    return psum((u * v).sum(dim=1))


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """The parts' (P, m) pieces as one (P*m,) vector, part-major."""
    return x.reshape(-1)
