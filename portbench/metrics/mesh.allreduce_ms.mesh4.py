"""Consensus mesh: median over the window's steps of rank 0's allreduce_ms, the step's summed device time inside its collectives (CUDA events on the learner's stream), the wait on peers included."""
from portbench.readers import pass_ms as _reader

read = _reader("allreduce_ms")
