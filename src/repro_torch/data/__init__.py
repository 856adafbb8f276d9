"""Synthetic datasets and federated partitions (numpy), the JAX
package's ``data``."""
from .synthetic import (classification_dataset, ClassificationData,  # noqa
                        char_stream, lm_round_batches, lm_client_batches)
from .federated import (FederatedDataset, partition_iid,  # noqa
                        partition_noniid_shards)
