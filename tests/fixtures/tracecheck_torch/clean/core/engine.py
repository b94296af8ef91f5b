"""tracecheck fixture: the contract-conformant forms of each rule.

Every pattern here is the sanctioned counterpart of a bad/ violation:
the corpus must produce ZERO findings under the shipped config.
"""

import numpy as np
import torch


class _Search:
    def round(self, data, dnear, rnd):
        # One launch a round, no Python loop (TRC002 counterpart); a
        # shape read is host arithmetic, not a sync (TRC001 negative).
        n = int(data.shape[0])
        return torch.minimum(dnear, torch.sum(torch.abs(data - data[rnd % n]),
                                              dim=1))


class MaskedStatsBackend:
    def top2(self, dmat):
        # A where-mask inside the pass, not an inf fill (TRC005
        # counterpart).
        a = torch.argmin(dmat, dim=1)
        cols = torch.arange(dmat.shape[1])
        d2 = torch.min(torch.where(cols[None, :] == a[:, None],
                                   float("inf"), dmat), dim=1).values
        return torch.min(dmat, dim=1).values, d2, a.to(torch.int32)

    def justified(self, x: torch.Tensor):
        # Suppression WITH a justification: suppressed, and no TRC000.
        # tracecheck: ignore[TRC001] -- fixture: demonstrates a justified
        # suppression; x is a host scalar at every call site.
        return float(x)


def host_driver(data):
    # Host orchestration may read: not round-reachable (TRC001 negative).
    d = torch.as_tensor(data, dtype=torch.float32)
    total = float(np.asarray(d).sum())
    for _ in range(2):  # host loop: TRC002 negative
        total += 1.0
    return total
