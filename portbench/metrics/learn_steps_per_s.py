"""Outer consensus steps the learner's own loop completed in the window's call, over that call's wall."""
from portbench.readers import learn_steps_per_s as _reader

read = _reader
