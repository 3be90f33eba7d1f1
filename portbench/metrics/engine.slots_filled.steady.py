"""Serving engine: requests over slots, summed over the window's dispatches (CodecEngine.dispatch_log)."""
from portbench.readers import slots_filled_pct as _reader

read = _reader
