from llark_tpu_torch.instruct import FewShotExample  # noqa: F401
