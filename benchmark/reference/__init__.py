"""The benchmark's plain reference of the foveated frame and of the dense
inverse-rendering step.

A frozen copy of fovtrace_torch's plain PyTorch route (what the port runs
on CPU tensors), taken when the benchmark was written, with every
hand-written kernel replaced by its plain version on any device: the
cluster intersection walks, the material table's row gather and the
envmap's bilinear lookup, whose gradients autograd sums. It imports
nothing of the program. It builds its own intersection pack, from
triangles sorted along a Morton curve instead of the program's BVH leaf
order, so it shares no derived table with the program.
"""
