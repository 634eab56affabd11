"""Row bands and camera batches: the sharded render entry points."""
