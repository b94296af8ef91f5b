"""tracecheck fixture: TRC005 vmap in a batch driver."""

import torch


def _swap_batch(data, meds):
    # TRC005: the lane contract is lockstep lanes, each the single fit.
    return torch.vmap(lambda d, m: d[m].sum(dim=-1))(data, meds)
