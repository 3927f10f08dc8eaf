"""Attention ops: plain PyTorch paths and the hand-written Hopper kernels."""
