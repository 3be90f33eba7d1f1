"""Process start to the first timed request or step: imports, the CUDA context, inputs, plans, the kernels (built on a checkout's first run) and the cell's shapes warmed."""
from portbench.readers import setup_s as _reader

read = _reader
