"""The fused CUDA kernels, their plain versions, and their build."""
