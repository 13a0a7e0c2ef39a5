"""Intersection, sampling and reconstruction kernels."""

import collections

# launches of each CUDA kernel and calls of each plain version and brute
# oracle, counted where they run (see cluster_isect.counters), and the
# camera inverse's host round trips ("inv4_host", core/camera.inv4)
CALLS: collections.Counter = collections.Counter()
