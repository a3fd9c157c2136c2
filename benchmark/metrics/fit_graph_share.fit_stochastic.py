"""As fit_graph_share.fit, in the one-corner encode's cell (its own name, to
move ``nerf_train_rays_per_s.stochastic``)."""
import os

from benchmark.harness.spec import metric_reader

read = metric_reader("fit_graph_share.fit",
                     os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
