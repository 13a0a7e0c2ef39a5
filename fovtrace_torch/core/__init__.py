"""Core math: SoA vectors, RNG, camera, tone mapping, reprojection."""
