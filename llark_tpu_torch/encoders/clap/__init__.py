from llark_tpu_torch.encoders.clap.encode import ClapEncoder  # noqa: F401
from llark_tpu_torch.encoders.clap.htsat import HTSATConfig  # noqa: F401
