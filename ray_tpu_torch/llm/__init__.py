"""LLM inference of the PyTorch port: paged KV cache, continuous batching
and the server front end (``ray_tpu.llm`` counterparts)."""
