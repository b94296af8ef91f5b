"""tracecheck fixture: the sanctioned draw chain (TRC003 negatives)."""

import torch


def _phase_key(seed, tag, step):
    # Sanctioned chain head (the config lists `_phase_key`): the one
    # generator, seeded from the documented chain.
    return torch.Generator().manual_seed((seed ^ tag) * 1_000_003 + step)


def round_draw(chain, n):
    # Draws take the chain's generator, never the global one.
    return torch.randint(0, n, (n,), generator=chain)
