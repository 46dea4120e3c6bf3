"""Launchers of the port (``repro.launch``): ``train`` and ``serve`` (the LM,
on one device or a mesh), ``serve_ode`` (``SolveService``), and the mesh
and abstract-spec helpers ``mesh`` and ``specs``."""
