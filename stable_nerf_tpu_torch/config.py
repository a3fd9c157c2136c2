"""Configuration dataclasses of the joint train and serving steps.

The port's own copies of the reference package's configuration classes,
with the same names and defaults, holding the fields the ported steps
read.  ``convert.config_from_jax`` converts a reference
configuration field by field and refuses one that sets a field the port
does not have.  Plain dataclasses: nothing here imports torch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class HashGridConfig:
    """Multiresolution hash-grid encoding (instant-ngp / tcnn HashGrid)."""

    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    # exp2(log2(2048/16)/15): the finest level has resolution 2048
    per_level_scale: float = float(2.0 ** (math.log2(2048 / 16) / (16 - 1)))

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features_per_level


@dataclass(frozen=True)
class SHConfig:
    """Spherical-harmonics direction encoding."""

    degree: int = 4

    @property
    def output_dim(self) -> int:
        return self.degree ** 2


@dataclass(frozen=True)
class MLPConfig:
    """Bias-free fully connected net with relu (tcnn FullyFusedMLP)."""

    n_neurons: int = 128
    n_hidden_layers: int = 3


@dataclass(frozen=True)
class NeRFConfig:
    """The instant-ngp style latent/RGB NeRF."""

    channel_dim: int = 3          # 3 = RGB, 4 = SDXL latent
    geo_feat_dim: int = 15
    bound: float = 1.0
    density_scale: float = 1.0
    min_near: float = 0.2
    # occupancy threshold cap of the grid refresh (models/nerf/grid.py)
    density_thresh: float = 0.01
    grid_size: int = 128
    # table gradient through the hand-written scatter kernel on the card
    # (ops/hopper/scatter.py); positions then get a zero gradient
    hash_custom_bwd: bool = True
    # training fast mode: one hash corner per level drawn ∝ its trilinear
    # weight instead of the 8-corner interpolation
    hash_stochastic: bool = False
    # hybrid: exact interpolation on levels below this index, one corner
    # on the rest (0 = fully stochastic, >= n_levels = exact)
    hash_stochastic_min_level: int = 0
    # round table-gradient updates to bf16 before they are summed
    hash_grad_bf16: bool = False
    density_activation: str = "relu"     # relu | trunc_exp
    encoding_sigma: HashGridConfig = field(default_factory=HashGridConfig)
    network_sigma: MLPConfig = field(default_factory=lambda: MLPConfig(n_hidden_layers=3))
    encoding_dir: SHConfig = field(default_factory=SHConfig)
    network_color: MLPConfig = field(default_factory=lambda: MLPConfig(n_hidden_layers=4))

    @property
    def cascade(self) -> int:
        return 1 + math.ceil(math.log2(max(self.bound, 1.0)))


@dataclass(frozen=True)
class TinyNeRFConfig:
    """The tiny-NeRF parity config (reference test_nerf.py:146-166)."""

    n_layers: int = 8
    width: int = 256
    n_freqs_pos: int = 6
    n_freqs_dir: int = 4
    n_samples: int = 64
    near: float = 2.0
    far: float = 6.0
    use_viewdirs: bool = True


@dataclass(frozen=True)
class SDConfig:
    """SDXL + IP-Adapter stack."""

    num_tokens: int = 2
    use_downsampling_layers: bool = True
    cross_attention_dim: int = 2048
    latent_channels: int = 4
    # IP image-embed channels: 4 latent + 3 ray directions
    cond_channels: int = 7
    latent_size: int = 64
    image_size: int = 512
    ip_scale: float = 1.0


@dataclass(frozen=True)
class SchedulerConfig:
    """DDIM with the SDXL base scheduler settings."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    clip_sample: bool = False
    set_alpha_to_one: bool = False
    steps_offset: int = 1
    prediction_type: str = "epsilon"
    timestep_spacing: str = "leading"


@dataclass(frozen=True)
class TrainConfig:
    """The joint step's and the training loop's settings."""

    batch_size: int = 1
    epochs: int = 500
    # DDIM inference on the test split every N epochs (0 = never)
    inference_every: int = 50
    lr: float = 1e-4
    weight_decay: float = 1e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    grad_accum_steps: int = 1
    # constant | exponential | cosine; a decay runs over lr_decay_steps
    # optimizer updates and ends at lr × lr_decay_factor
    lr_schedule: str = "constant"
    lr_decay_steps: int = 100_000
    lr_decay_factor: float = 0.1
    # separate lr for the NeRF parameters (None = one lr for all)
    nerf_lr: Optional[float] = None
    # seed of the data split, the shuffles and the inference draws
    seed: int = 0
    max_steps_train: int = 256
    max_steps_eval: int = 512
    # background for unterminated rays: scalar or [channel_dim]
    bg_color: Any = 1.0
    # DDIM steps of the inference denoise loop
    num_inference_steps: int = 50
    # resumable checkpoint every N epochs (0 = only at the end)
    checkpoint_every: int = 50
    # checkpoint only the trainable partition; the frozen one is rebuilt
    # from (seed, frozen_dtype, trainable_scope), recorded in FORMAT.json
    checkpoint_trainable_only: bool = False
    log_every: int = 10
    # validation every N epochs (and at the last one); 0 = never
    val_every: int = 1
    # probability of dumping a step's noisy latents / noise prediction to
    # <workdir>/visualizations/ (0 disables the dumps)
    vis_sample_prob: float = 0.0125
    # storage dtype of the frozen partition (None = float32); the step
    # computes in bf16 either way
    frozen_dtype: Optional[str] = None
    trainable_scope: str = "reference"   # reference | sd
    vae_encode: str = "sample"           # sample | mode
    # static NeRF sample budget of a train step (None = dense lattice)
    sample_budget: Optional[int] = None
    # re-bucket the train budget from the occupancy at every grid refresh
    sample_budget_auto: bool = False
    # train the first N epochs with the one-corner stochastic encode, then
    # the exact one (0 = no schedule)
    stochastic_until_epoch: int = 0
    # eval-render sample budget (None: sample_budget_eval_per_ray per ray;
    # a per-ray value of 0 is the dense [N, max_steps_eval] lattice)
    sample_budget_eval: Optional[int] = None
    sample_budget_eval_per_ray: int = 64
    # occupancy-driven eval budget: when the caller supplies the grid's
    # occupied fraction, the budget is suggest_sample_budget(occ, n_rays,
    # max_steps_eval), capped at the static per-ray default
    sample_budget_eval_auto: bool = True
