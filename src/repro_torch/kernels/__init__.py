"""The port's kernels: the four CFD stencils (hand-written CUDA plus their
plain versions), the plain fused Jacobi smoother and the op surface."""
