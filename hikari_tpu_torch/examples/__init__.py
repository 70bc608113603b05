"""The headless entry points of the port, counterparts of ``examples/``:
``render`` (a config to a PNG) and ``dissect`` (the per-pass PNG set)."""
