"""Scene representation, BVH build and the procedural scenes."""
