"""tracecheck fixture: collective-free StatsBackend (TRC004 negative)."""

import torch


class PartialSumStatsBackend:
    name = "partial"

    def build_stats_from_d(self, dxy, dnear_b, w):
        # Per-shard partial sums only; the sharded fit composes them with
        # its one all_reduce.
        g = torch.clamp_max(dxy - dnear_b[None, :], 0.0) * w[None, :]
        return torch.sum(g, dim=1)
