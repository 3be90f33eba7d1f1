"""Requests whose results came back inside the window, over the window's seconds."""
from portbench.readers import served_rps as _reader

read = _reader
