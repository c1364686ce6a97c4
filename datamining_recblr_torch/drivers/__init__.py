from datamining_recblr_torch.drivers.experiment import run_experiment  # noqa: F401
