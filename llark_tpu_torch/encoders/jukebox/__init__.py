from llark_tpu_torch.encoders.jukebox.config import JukeboxPriorConfig, JukeboxVQVAEConfig  # noqa: F401
from llark_tpu_torch.encoders.jukebox.encode import (  # noqa: F401
    ACTS_SAMPLE_RATE,
    JUKEBOX_EXPECTED_SAMPLES_LEN,
    JUKEBOX_SAMPLE_RATE,
    JukeboxEncoder,
)
