"""As nerf_train_rays_per_s, in the one-corner encode's cell (its own
name, for its own bound)."""
import os

from benchmark.harness.spec import metric_reader

read = metric_reader("nerf_train_rays_per_s",
                     os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
