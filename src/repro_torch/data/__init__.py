from repro_torch.data.federated_data import dirichlet_mixtures, federated_batch
from repro_torch.data.pipeline import SyntheticCorpus, batch_iterator

__all__ = ["SyntheticCorpus", "batch_iterator", "dirichlet_mixtures", "federated_batch"]
