"""tracecheck fixture: TRC004 collective inside a StatsBackend."""

import torch
import torch.distributed as dist


class ShardedStatsBackend:
    name = "sharded"

    def build_stats_from_d(self, dxy, dnear_b, w):
        g = torch.clamp_max(dxy - dnear_b[None, :], 0.0) * w[None, :]
        out = torch.sum(g, dim=1)
        # TRC004: backends are collective-free by contract; the
        # all_reduce composition point belongs to the sharded fit.
        dist.all_reduce(out)
        return out
