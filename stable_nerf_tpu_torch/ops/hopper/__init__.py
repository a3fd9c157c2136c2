"""Wrappers of the hand-written Hopper (sm_90a) kernels in ``csrc/``.

Each wrapper launches its kernel for a tensor on the card and raises on
what the kernel does not take; there is no fallback from one to the
other.  The scatter and gather wrappers take their plain PyTorch versions
for a tensor on the CPU; the encode's plain version is
``ops/encoding.py``'s, whose ``hash_grid_encode`` chooses between them."""
