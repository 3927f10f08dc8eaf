"""Dataset preprocessing: jsonifiers + audio pipeline CLIs (counterpart of
llark_tpu/preprocessing/).

The reference implements this layer as Apache Beam/Dataflow pipelines
(reference: scripts/preprocessing/*); here each stage is a plain
multiprocess map — no Beam dependency (SURVEY.md §2.8: embarrassing data
parallelism belongs on hosts, not in a pipeline framework).
"""

from llark_tpu_torch.preprocessing.jsonify import get_jsonifier  # noqa: F401
