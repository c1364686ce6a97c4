from datamining_recblr_torch.config.config import Config, model_defaults  # noqa: F401
