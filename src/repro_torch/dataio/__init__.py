from repro_torch.dataio.synthetic import (  # noqa: F401
    synthetic_faces, synthetic_video, lm_token_stream)
from repro_torch.dataio.loader import ShardedLoader  # noqa: F401
