from gasr_tpu_torch.decoder.greedy import greedy_decode  # noqa: F401
from gasr_tpu_torch.decoder.beam_search import (  # noqa: F401
    BeamSearchResult, ctc_beam_search,
)
from gasr_tpu_torch.decoder.lm import (  # noqa: F401
    bigram_bias_from_arpa, bigram_bias_from_text,
)
