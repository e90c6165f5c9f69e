"""Core block-table data structures: the paged KV cache and BlockStack."""
