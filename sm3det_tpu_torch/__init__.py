"""PyTorch/CUDA port of SM3Det-TPU for NVIDIA Hopper.

A package beside ``sm3det_tpu`` (the JAX reference, which it never
imports). Plain tensor code is PyTorch; every Pallas kernel of the ported
path is a hand-written CUDA kernel under ``ops/cuda/csrc``. Public functions
keep the JAX package's NHWC layout. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``, which runs each kernel's plain version.

This slice: SAR inference, ``TriSourceDetector.simple_test(imgs, "sar")``.
"""
