"""d-pass: median over the window's steps of the learner trace's d_pass_ms (CUDA events at the pass's ends)."""
from portbench.readers import pass_ms as _reader

read = _reader("d_pass_ms")
