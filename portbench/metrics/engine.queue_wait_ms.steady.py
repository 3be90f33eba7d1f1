"""Serving engine: median of the engine's own submit-to-dispatch-start time (ServedResult.wait_s) over the window's requests."""
from portbench.readers import queue_wait_ms as _reader

read = _reader
