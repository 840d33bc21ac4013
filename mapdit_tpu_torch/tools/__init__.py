"""The tools that read model outputs, port of the JAX package's ``tools/``:
sample-quality metrics (``fid``), the distribution-recovery probe
(``distribution_probe``), the guidance sweep (``guidance_sweep``) and the
full-scale FID protocol runner (``run_fid50k``). Each runs as ``python -m
mapdit_tpu_torch.tools.<name>``."""
