"""The ranks' balance over the pixel tiles: the largest rank's rays a step
over the mean of all ranks' rays a step, from each rank's ``rays`` counters
on its ``rt.p.level.<k>`` spans in the profiled stretch (``ctx.rank_rays``,
gathered by ``rtbench/shard.py``). 1 is balanced; the slowest tile sets the
step. None without several ranks' counters."""


def read(ctx):
    rays = getattr(ctx, "rank_rays", None)
    if not rays or len(rays) < 2 or any(r is None for r in rays) or not sum(rays):
        return None
    return max(rays) / (sum(rays) / len(rays))
