"""PyTorch/CUDA port of the CE-CoLLM serving stack.

Mirrors ``src/repro``'s module names; imports ``torch`` and nothing of the
JAX package.  The decode hot path runs through the hand-written Hopper
kernels in ``repro_torch.kernels`` (sources in ``csrc/``); every entry
point runs on ``cuda`` unless the caller passes ``device="cpu"``, where the
kernels' plain PyTorch versions run instead.
"""
