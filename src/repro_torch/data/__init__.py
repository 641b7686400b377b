from repro_torch.data.shakespeare import CharDataset, load_corpus, sample_batch  # noqa: F401
from repro_torch.data.federated import FederatedData  # noqa: F401
from repro_torch.data.synthetic import synthetic_batch  # noqa: F401
