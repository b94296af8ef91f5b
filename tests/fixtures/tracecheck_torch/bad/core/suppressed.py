"""tracecheck fixture: TRC000, a suppression without a justification.

The bare ignore below DOES suppress its TRC001 target, but the missing
`-- reason` raises TRC000 instead.
"""

import torch


class PlainStatsBackend:
    def loss(self, x: torch.Tensor):
        return float(x)  # tracecheck: ignore[TRC001]
