from gasr_tpu_torch.data.features import logmel_torch  # noqa: F401
from gasr_tpu_torch.data.dataset import SyntheticDataset, text_to_ids  # noqa: F401
