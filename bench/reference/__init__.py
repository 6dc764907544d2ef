"""The plain reference the benchmark judges the port against: PyTorch and
NumPy only, nothing of the port.  It works out again, from the inputs the
benchmark hands to both sides, what the port derived."""
