"""ASCII database/query parsing and bucket packing."""
