"""The benchmark harness of fovtrace_torch (see benchmark/run.py)."""
