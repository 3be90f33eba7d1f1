"""Consensus mesh: median over the window's steps of the bytes rank 0 handed to collectives a step (the learner trace's wire_bytes, the mesh's counter), in MB (1e6 bytes)."""
import statistics


def read(run):
    v = (run.learn_trace or {}).get("wire_bytes")
    return statistics.median(v) / 1e6 if v else None
