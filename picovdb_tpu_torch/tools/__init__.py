"""Command-line tools that drive picovdb_tpu_torch through its public API."""
