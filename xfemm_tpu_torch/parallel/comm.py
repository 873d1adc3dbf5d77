"""The parts' communicator: the three collectives of the JAX package's
domain decomposition, in two implementations.

The JAX package runs each part of a domain decomposition on its own
device inside ``shard_map`` and joins them with three collectives:
``ppermute`` (the ring halo exchange), ``psum`` (dot products) and
``all_gather`` (the sidecar's and the coarse solve's global vector).

**Stacked** (the module's functions, and :data:`STACKED`): every part's
state is one slice ``x[p]`` of a tensor whose leading axis counts the
parts, all on one device, and the operations are tensor operations on
that axis:

- ``ring_shift``: part d receives part d-1's strip (``step=+1``) or part
  d+1's (``step=-1``); the part at the open end of the ring receives
  zeros, as the JAX code masks it (``halo.py``'s ``jnp.where(me == 0,
  0.0, halo)``);
- ``psum``: the sum over the parts, added in part order, so the result
  does not depend on a reduction tree;
- ``all_gather``: the parts' pieces as one vector, part-major.

**Process group** (:class:`GroupComm`): one process per part (per card,
under ``torchrun`` or ``launch.spawn``). A rank's tensors carry a leading
axis of 1, its own part, global index ``rank``, and each operation
returns exactly what the stacked one returns for slice ``[rank]``.

Each part's arithmetic is written as the JAX per-device body, with one
more leading axis; the bodies take the communicator as an argument.
"""

from __future__ import annotations

import hashlib

import numpy as np
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


class Stacked:
    """Every part on one device: the module's functions as an object,
    so a body takes either communicator as an argument."""

    #: whether several processes must launch the same loop iterations
    #: (the ranks of a group; ``loop.masked_loop`` stops every rank at
    #: the same one): one process holds every part here
    lockstep = False

    ring_shift = staticmethod(ring_shift)
    psum = staticmethod(psum)
    pdot = staticmethod(pdot)
    all_gather = staticmethod(all_gather)

    @staticmethod
    def local(a):
        """The rows of a (P, ...) array that this process holds: all."""
        return a

    @staticmethod
    def check_same(x: np.ndarray, what: str) -> None:
        """One process holds every part: nothing can drift apart."""


#: the stacked communicator (stateless)
STACKED = Stacked()


class GroupComm:
    """One part per rank of a ``torch.distributed`` process group.

    Every operation is one ``all_reduce(SUM)`` of a zero-padded (P, ...)
    buffer in which the rank fills its own row: adding zeros is exact in
    IEEE arithmetic, so the gathered rows do not depend on the backend's
    reduction order, and the same code runs on NCCL and gloo. The buffer
    lives where the backend reduces: on the rank's card for NCCL, on the
    host for gloo (a CUDA tensor under gloo is copied to the host,
    reduced there and copied back). Sums over the parts are then added
    in part order, as :func:`psum` adds them, so every rank holds
    bitwise the same scalar.
    """

    lockstep = True

    def __init__(self, group):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        on_host = dist.get_backend(group) == "gloo"
        self._home = (torch.device("cpu") if on_host else
                      torch.device("cuda", torch.cuda.current_device()))

    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(1, ...) -> every rank's row, (P, ...), on ``x``'s device."""
        if x.shape[0] != 1:
            raise ValueError(f"GroupComm: a rank holds one part, not "
                             f"{x.shape[0]}")
        buf = torch.zeros((self.world,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=self._home)
        buf[self.rank] = x[0].to(self._home)
        self._dist.all_reduce(buf, op=self._dist.ReduceOp.SUM,
                              group=self.group)
        return buf.to(x.device)

    def ring_shift(self, x: torch.Tensor, step: int) -> torch.Tensor:
        """This rank's row of the stacked ``ring_shift``: part rank-step's
        strip, zeros at the open end of the ring (by global rank)."""
        if step not in (1, -1):
            raise ValueError(f"ring_shift: step {step} (one part, +1 or -1)")
        rows = self._gather_rows(x)
        sender = self.rank - step
        if 0 <= sender < self.world:
            return rows[sender:sender + 1]
        return torch.zeros_like(x)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over every rank's part, added in part order."""
        return psum(self._gather_rows(x))

    def pdot(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.psum((u * v).sum(dim=1))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's (1, m) piece as one (P*m,) vector, part-major."""
        return self._gather_rows(x).reshape(-1)

    def local(self, a):
        """This rank's row of a (P, ...) array, as a (1, ...) slice."""
        return a[self.rank:self.rank + 1]

    def check_same(self, x: np.ndarray, what: str) -> None:
        """Raise on every rank unless every rank holds bitwise the same
        ``x`` (ranks that drift apart would deadlock at their next
        collective instead)."""
        digest = hashlib.blake2b(np.ascontiguousarray(x).tobytes(),
                                 digest_size=8).digest()
        mine = torch.tensor([[int.from_bytes(digest, "little", signed=True)]],
                            dtype=torch.int64)
        sums = self.all_gather(mine)
        if bool((sums != sums[0]).any()):
            raise RuntimeError(
                f"{what}: the ranks' results differ (checksums "
                f"{sums.tolist()}); their host state has drifted apart")
