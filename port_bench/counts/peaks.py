"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
700 W): the TF32 tensor-core rate is the ceiling of any float32-accurate
product (the kernels multiply in 3xTF32 there), and the HBM3 bandwidth."""

TF32_FLOPS = 495e12
HBM_BYTES = 3.35e12
