"""Models: the dense GQA/MQA decoder on the paged KV cache."""
