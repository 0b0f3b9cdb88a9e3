"""PyTorch / CUDA port of epipolar_transformers_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (geometry/, ops/, models/, data/, engine/,
utils/).  Imports torch and never JAX: the only parts of the JAX package it
uses are its JAX-free config (`epipolar_transformers_tpu.config`), the
torch-key name map (`epipolar_transformers_tpu.utils.torch_import`), the
affine transforms and `collate`.  The epipolar attention runs through the
hand-written CUDA kernel in csrc/ on the card and its plain PyTorch twin on
the CPU.
"""

__version__ = "0.1.0"
