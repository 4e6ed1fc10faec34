"""More than one GPU: the process group, batch placement and host prefetch
(counterpart of gennerf_tpu/parallel/)."""
