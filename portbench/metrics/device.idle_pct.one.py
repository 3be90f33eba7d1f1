"""Device: share of the traced stretch in which no device operation ran (the union of their intervals, not the sum)."""
from portbench.readers import idle_pct as _reader

read = _reader
