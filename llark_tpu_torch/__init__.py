"""PyTorch/CUDA port of llark_tpu for one NVIDIA Hopper GPU.

Mirrors the layout and names of `llark_tpu`; imports nothing of JAX or of
`llark_tpu`. Hand-written CUDA kernels live in `csrc/` and are built at
first use (`ops/_build.py`).
"""
