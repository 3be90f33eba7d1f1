"""K1, the engine's Sherman-Morrison z-solve: the bytes its dispatches in the traced stretch needed at 3.35 TB/s over the device time of the z-solve kernels (readers.k1_roofline)."""
from portbench.readers import k1_roofline as _reader

read = _reader
