"""Runtime pieces the in-process pipeline needs: relay-tree pricing and
the flight recorder."""
