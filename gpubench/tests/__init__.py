"""CPU tests of the benchmark; see ``gpubench/conftest.py``."""
