"""Terrain generators, one module a ``kind`` named by a traffic file, and
the harness's own depression-free fill (:mod:`.fill`)."""
