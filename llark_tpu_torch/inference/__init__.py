"""Serving: the continuous-batching engine (`server.BatchedServer`), its
paged-KV helpers and the batch-inference CLI (counterpart of
llark_tpu/inference/)."""
