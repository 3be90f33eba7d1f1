"""z-pass: median over the window's steps of the learner trace's z_pass_ms (CUDA events at the pass's ends)."""
from portbench.readers import pass_ms as _reader

read = _reader("z_pass_ms")
