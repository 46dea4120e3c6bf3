"""Measurement tools for the port: the main-path workloads of
``chip_smoke.py`` and a per-step profile of them on the card."""
