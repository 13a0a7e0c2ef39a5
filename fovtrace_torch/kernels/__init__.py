"""Intersection, sampling and reconstruction kernels."""

import collections

# launches of each CUDA kernel and calls of each plain version and brute
# oracle, counted where they run (see cluster_isect.counters)
CALLS: collections.Counter = collections.Counter()
