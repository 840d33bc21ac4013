"""PyTorch/CUDA port of mapdit_tpu: MaP-DiT sampling and training on NVIDIA Hopper.

A package of its own beside the JAX reference ``mapdit_tpu``, with the same
module layout. It imports torch, numpy and the standard library only. Entry
points run on CUDA unless the caller passes another device.
"""
