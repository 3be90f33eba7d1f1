"""Device: share of rank 0's traced learner call in which no device operation ran on its card (the union of their intervals, not the sum), as device.idle_pct.learn reads it."""
from portbench.readers import idle_pct as _reader

read = _reader
