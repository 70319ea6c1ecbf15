"""p2p_tpu_torch: the PyTorch + CUDA port of p2p_tpu for NVIDIA Hopper.

Pure PyTorch around hand-written Hopper kernels (``ops/cuda/``); it imports
nothing of JAX or of the ``p2p_tpu`` package. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
