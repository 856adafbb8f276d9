from .synthetic import (classification_dataset, ClassificationData,  # noqa
                        char_stream)
from .federated import (FederatedDataset, partition_iid,  # noqa
                        partition_noniid_shards)
