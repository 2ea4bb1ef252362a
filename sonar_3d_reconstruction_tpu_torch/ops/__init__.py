"""Per-ping operations: backprojection, key packing, dedup, records."""
