from datamining_recblr_torch.data.dataset import SeqData, SplitArrays  # noqa: F401
