"""Training data: shards -> conversations -> tokens -> fixed-shape numpy batches."""
