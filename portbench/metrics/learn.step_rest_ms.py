"""Outer step: median over the window's steps of the learner trace's step_rest_ms (CUDA events: the step, top to its metrics stacked, less its d-pass and z-pass)."""
from portbench.readers import pass_ms as _reader

read = _reader("step_rest_ms")
