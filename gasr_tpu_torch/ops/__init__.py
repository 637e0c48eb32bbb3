from gasr_tpu_torch.ops.linear import linear, linear_init  # noqa: F401
from gasr_tpu_torch.ops.rnn import rnn_forward, rnn_init  # noqa: F401
