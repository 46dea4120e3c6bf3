"""Launchers of the port (``repro.launch``): ``serve`` on one device."""
