from datamining_recblr_torch.unseen.features import (  # noqa: F401
    load_item_text_features,
    prepare_item_features,
    synthesize_item_features,
)
from datamining_recblr_torch.unseen.similarity import ItemSimilarity  # noqa: F401
