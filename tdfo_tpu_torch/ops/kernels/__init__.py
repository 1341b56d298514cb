"""Hand-written Hopper kernels: wrappers, plain versions and the nvcc build."""
