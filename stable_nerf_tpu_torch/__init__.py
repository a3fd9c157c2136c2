"""stable_nerf_tpu_torch: the PyTorch and CUDA port of stable_nerf_tpu for
an NVIDIA H100.

Layout mirrors the JAX package so each module's counterpart is easy to
find:
  ops/        ray/AABB geometry, lattice march, hash/SH encodings, the
              composite with its closed-form backward; ops/hopper/ holds
              the wrappers of the hand-written CUDA kernels (sources in
              csrc/)
  models/     NeRF network, renderer and occupancy grid; SDXL VAE, U-Net with two-stream
              IP attention, DDIM scheduler
  training/   the joint Stable-NeRF train and eval steps, DDIM inference,
              checkpoints and the training loop
  data/       rays, the synthetic/tiny-NeRF loaders, the paired dataset,
              device prefetch
  parallel/   training across processes: data parallelism over a
              torch.distributed group, fully-sharded data parallelism
  utils/      losses, devices, parameter trees, timing, debug dumps
  convert.py  parameter trees to and from the JAX package's layout
  train.py    the command line: python -m stable_nerf_tpu_torch.train

Importing the package imports nothing: entry points live in the modules.
"""
