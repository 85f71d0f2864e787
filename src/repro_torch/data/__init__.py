from repro_torch.data.pipeline import (RingLoader, TokenStore,
                                       make_synthetic_corpus)
