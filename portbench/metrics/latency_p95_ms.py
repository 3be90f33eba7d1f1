"""95th percentile of every completed request's time from when it was due (open loop) or sent (closed loop) to its result on the host."""
from portbench.readers import latency_ms as _reader

read = _reader(95.0)
