"""Frame stages: G-buffer, wavefront shading, the frame pipeline."""
