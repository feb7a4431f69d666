"""Random draws that do not depend on how the envs are sharded.

The JAX package keeps one PRNG key per env, so an env's noise is the same
whatever the number of shards (PARITY.md §4).  The port draws from one
``torch.Generator`` per object instead, and keeps the same property this
way: every rank makes each draw at the GLOBAL shape (N_global, ...) from a
generator in the same state, and keeps its own rows
``[rank·n, (rank+1)·n)``.  All ranks then consume their generators alike,
so the generators stay equal on every rank (rank 0's checkpoint holds them)
and at every world size.  At world size 1 a draw is exactly the unsharded
draw.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


def local_envs(num_envs: int, shard: "Shard") -> int:
    """The envs one shard holds of ``num_envs`` global envs."""
    if num_envs % shard.world:
        raise ValueError(f"num_envs {num_envs} must divide by the world size "
                         f"{shard.world}")
    return num_envs // shard.world


class Shard(NamedTuple):
    """This process's block of the global env axis."""

    rank: int = 0
    world: int = 1

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This shard's rows of a tensor with the global env axis first."""
        n = x.shape[0] // self.world
        return x[self.rank * n:(self.rank + 1) * n]

    def draw(self, fn: Callable[..., torch.Tensor], shape, **kw) -> torch.Tensor:
        """``fn(global_shape, **kw)`` (``torch.rand``, ``torch.randn``, ...)
        cut to this shard's rows; ``shape`` is the local shape."""
        shape = tuple(shape)
        full = fn((shape[0] * self.world, *shape[1:]), **kw)
        return self.rows(full)

    def randint(self, high: int, n: int, **kw) -> torch.Tensor:
        """``torch.randint(0, high, (n,))`` drawn the same way."""
        return self.rows(torch.randint(0, high, (n * self.world,), **kw))

    def perm(self, T: int, n: int, generator: torch.Generator,
             device) -> torch.Tensor:
        """A random order of this shard's T·n samples (index t·n + e of a
        (T, n) batch): one permutation of the global T·(n·world) samples,
        restricted to this shard's envs.  Each rank's minibatches come
        from its own samples, and the generator advances alike at every
        world size."""
        g = torch.randperm(T * n * self.world, generator=generator,
                           device=device)
        if self.world == 1:
            # every sample is this shard's: no mask, whose length the host
            # would have to read
            return g
        t, e = g // (n * self.world), g % (n * self.world) - self.rank * n
        mine = (e >= 0) & (e < n)
        # this shard's T·n samples in the global order: a stable sort that
        # puts them first, in place of a mask, whose length the host would
        # have to read (a captured learning half holds this)
        order = torch.argsort((~mine).to(torch.uint8), stable=True)[:T * n]
        return t[order] * n + e[order]
