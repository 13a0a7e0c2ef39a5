"""Command-line entry point, gaze trajectories, per-frame report."""
