"""tracecheck fixture: TRC005 inf fill on a streaming path."""

import torch


def top2(dmat):
    a = torch.argmin(dmat, dim=1)
    rows = torch.arange(dmat.shape[0])
    # TRC005: materialises a full masked copy; the streaming contract is
    # online (min, min2) accumulation.
    masked = dmat.index_put((rows, a), torch.tensor(torch.inf))
    return torch.min(dmat, dim=1).values, torch.min(masked, dim=1).values, a
