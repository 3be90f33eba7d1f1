"""K2, the learner's fused z-iteration: its bytes at 3.35 TB/s over the device time of its two passes in the traced call (readers.k2_roofline)."""
from portbench.readers import k2_roofline as _reader

read = _reader
