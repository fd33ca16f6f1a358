"""The port's benchmark: one cell (a model configuration under a traffic
mix) per run, served over HTTP by ``evossearch_tpu_torch``, driven by the
data files in this folder. See README.md."""
