from datamining_recblr_torch.models.base import get_model  # noqa: F401
