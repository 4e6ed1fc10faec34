"""models of the gennerf_tpu_torch port."""
