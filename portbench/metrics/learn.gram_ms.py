"""d-pass: median over the window's steps of the learner trace's gram_ms (CUDA events from the d-pass's start to its code Grams and their inverses built)."""
from portbench.readers import pass_ms as _reader

read = _reader("gram_ms")
