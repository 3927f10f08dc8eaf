"""The port's native host libraries: the audio library and the tar loader."""

from llark_tpu_torch.native.build import calls, load_library  # noqa: F401
