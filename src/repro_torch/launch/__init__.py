"""Launchers of the port (``repro.launch``): ``serve`` (the LM) and ``serve_ode``
(``SolveService``), each on one device."""
