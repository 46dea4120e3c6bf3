"""Step functions of the port (``repro.train``): serving only so far."""
