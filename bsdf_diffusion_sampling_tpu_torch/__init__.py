"""PyTorch and CUDA port of the diffusion BSDF sampler, for NVIDIA Hopper.

The JAX package beside this one is the reference: each module here keeps
its counterpart's path and function names. Plain tensor code is PyTorch;
each Pallas kernel of the reference is a CUDA kernel under `csrc/`, built
at first use. Entry points run on the card unless the caller asks for the
CPU, where each kernel's plain PyTorch version stands in for it.
"""
