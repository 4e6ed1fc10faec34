"""CPU tests of the benchmark (run from the repo root: python -m pytest portbench/tests)."""
