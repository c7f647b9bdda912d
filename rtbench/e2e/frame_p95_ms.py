"""The nearest-rank 95th percentile of every frame's latency in the window,
from its start to its synchronised image, ms."""


def p95(values: list) -> float:
    s = sorted(values)
    return s[max(0, -(-95 * len(s) // 100) - 1)]


def read(ctx):
    return p95(ctx.latencies) * 1e3
