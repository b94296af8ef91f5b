"""tracecheck fixture: TRC003 draws outside the chain (the round-collision
bug shape)."""

import torch


def resample(n, step):
    # TRC003: a generator made outside a sanctioned chain head; two call
    # sites with equal `step` draw identical subsets.
    gen = torch.Generator().manual_seed(step)
    return torch.randint(0, n, (n,), generator=gen)


def draw_inline(n):
    # TRC003: a draw from the global generator, outside the chain.
    return torch.rand((n,))
