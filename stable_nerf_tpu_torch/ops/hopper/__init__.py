"""Wrappers of the hand-written Hopper (sm_90a) kernels in ``csrc/``.

Each wrapper takes its plain PyTorch version for a tensor on the CPU and
launches its kernel for a tensor on the card; there is no fallback from
one to the other."""
