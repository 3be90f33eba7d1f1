"""Solve loop: the window's dispatches' summed wall (dispatch_log wall_s) over their summed iterations."""
from portbench.readers import ms_per_iter as _reader

read = _reader
