"""Consensus mesh: median over the window's steps of the largest minus the smallest d_pass_ms + z_pass_ms among the ranks (CUDA events on each rank's card): the slowest rank sets the pace."""
import statistics


def read(run):
    per_rank = (run.learn_trace or {}).get("rank_pass_ms")
    if not per_rank or len(per_rank) < 2:
        return None
    skew = [max(step) - min(step) for step in zip(*per_rank)]
    return statistics.median(skew) if skew else None
