"""PyTorch + CUDA port of the BC-Tree P2HNNS system.

Mirrors the JAX package ``repro`` module by module (``core/``, ``kernels/``,
``data/``, ``launch/``, ``stream/``, ``checkpoint/``) and never imports it or
JAX.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the kernels are hand-written CUDA for Hopper
(``kernels/csrc/p2h_sweep.cu``, ``kernels/csrc/stacked_sweep.cu``).
"""
from repro_torch.core.api import BuildReport, P2HIndex

__all__ = ["P2HIndex", "BuildReport"]
