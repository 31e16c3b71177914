"""The benchmark harness of the PyTorch + CUDA port: it finds a cell's
configuration, traffic mix and per-layer metric readers by name in files
of their own, drives the port's daemon under that traffic, and judges
what the timed path produced against a plain reference."""
