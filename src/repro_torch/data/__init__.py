from repro_torch.data.federated_data import dirichlet_mixtures, federated_batch
from repro_torch.data.pipeline import SyntheticCorpus

__all__ = ["SyntheticCorpus", "dirichlet_mixtures", "federated_batch"]
