"""PyTorch / CUDA port of epipolar_transformers_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (config/, geometry/, ops/, models/, data/,
engine/, utils/).  Imports torch, never JAX, and nothing of the JAX
package: what it shares with it (the config tree and catalogs, the affine
helpers, `collate`, the torch-key name map) it keeps as its own copies.
The epipolar attention runs through the hand-written CUDA kernels in csrc/
on the card and their plain PyTorch twin on the CPU.
"""

__version__ = "0.1.0"
