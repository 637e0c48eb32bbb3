from gasr_tpu_torch.decoder.greedy import greedy_decode  # noqa: F401
from gasr_tpu_torch.decoder.beam_search import (  # noqa: F401
    BeamSearchResult, ctc_beam_search,
)
