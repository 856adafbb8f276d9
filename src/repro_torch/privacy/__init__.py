"""The membership-inference probe (paper §6) — the port of the JAX
package's ``repro.privacy``."""
from .mia import (mia_split, attack_features, train_attack_model,  # noqa
                  attack_auc, roc_auc, MIASplit)
