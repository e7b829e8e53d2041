"""Launchers of the port (mirrors ``repro.launch``): device placement and serving."""
