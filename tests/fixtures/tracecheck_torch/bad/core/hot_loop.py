"""tracecheck fixture: TRC001 host syncs + TRC002 loops in round code.

Never imported: parsed by tests/test_torch_analysis.py as a known-
violation corpus.  The directory shape (bad/core/) puts it in the same
rule scopes as repro_torch/core/.
"""

import numpy as np
import torch


class _Search:
    def round(self, data, n):
        total = torch.zeros(())
        for i in range(n):                             # TRC002: a launch a trip
            total = total + float(torch.sum(data[i]))  # TRC001: float() sync
        return np.asarray(total)                       # TRC001: numpy copy


def loop_body(carry):
    return carry + carry.item()                    # TRC001 via device_search


def run(c0, device_search):
    return device_search(stats_fn=loop_body, init=c0)


def _step(x):
    return x * 2


def host_driver(data):
    # NOT round-reachable: the host driver may read freely.
    out = _step(data)
    while float(out.sum()) < 0.0:                  # host loop: no finding
        out = _step(out)
    return out.item()
